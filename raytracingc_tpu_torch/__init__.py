"""raytracingc_tpu_torch: the renderer ported to PyTorch and CUDA.

The JAX package's exports (``raytracingc_tpu/__init__.py``): the scene data
model, the camera, the renderers (one-shot, tonemapped, progressive,
sharded over a ``torch.distributed`` mesh) and the scene loaders;
``fit_scene`` is imported lazily.
"""

__version__ = "0.1.0"

from raytracingc_tpu_torch.scene.types import (  # noqa: F401
    Triangles,
    Spheres,
    EnvParams,
    Scene,
)
from raytracingc_tpu_torch.camera import Camera, look_at_basis, primary_rays  # noqa: F401
from raytracingc_tpu_torch.render.renderer import render, render_image  # noqa: F401
from raytracingc_tpu_torch.render.progressive import render_progressive  # noqa: F401
from raytracingc_tpu_torch.parallel import make_mesh, render_sharded  # noqa: F401
from raytracingc_tpu_torch.scene.builder import (  # noqa: F401
    scene_from_obj,
    scene_from_triangles_txt,
)


def __getattr__(name):
    if name == "fit_scene":
        from raytracingc_tpu_torch.diff.optimize import fit_scene

        return fit_scene
    raise AttributeError(name)
