"""Differentiable rendering: gradient checks and inverse rendering.

Counterpart of ``raytracingc_tpu/diff``: :mod:`fd_check` holds autograd's
scene gradients against central finite differences (the pass rate of
BASELINE.json's "pixel-grad check"), :mod:`optimize` fits scene parameters
or the camera pose to a target image with ``torch.optim.Adam``. Both run
the integrator's differentiable fast forward (``early_exit=False,
compact=True``): the search on the card's kernels under ``torch.no_grad``,
the resolve, shading, environment light and camera under autograd.
"""

from raytracingc_tpu_torch.diff.fd_check import fd_check, pixel_grad_check  # noqa: F401
from raytracingc_tpu_torch.diff.optimize import (  # noqa: F401
    fit_camera,
    fit_scene,
    is_geometry_trained,
    leaf_filter,
)
