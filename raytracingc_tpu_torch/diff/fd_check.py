"""Finite-difference verification of autograd's scene gradients.

Counterpart of ``raytracingc_tpu/diff/fd_check.py``. For a scalar loss
``L(params)`` and a unit probe ``v``, ``(L(p + h v) - L(p - h v)) / 2h``
must match ``<grad L, v>``. The estimator is deterministic for a fixed seed
(counter-based RNG), so central differences are exact up to O(h²), except
where the step flips a discrete decision (closest hit, hit or miss,
backface, roulette survival), which the gradient treats as locally
constant. So the check reports a pass rate over many probes.

The probes come from ``numpy.random.default_rng(seed)`` in the JAX
package's leaf order, as there; :func:`pixel_grad_check`'s projection
weights come from a ``torch.Generator``, whose numbers differ from
``jax.random``'s, so the two packages are compared by pass rate, not probe
by probe.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import Any

import numpy as np
import torch

from raytracingc_tpu_torch.scene.types import Scene, scene_leaves, with_leaves


def _named(params) -> dict[str, torch.Tensor]:
    return scene_leaves(params) if isinstance(params, Scene) else dict(params)


def _rebuild(params, leaves: dict[str, torch.Tensor]):
    return with_leaves(params, leaves) if isinstance(params, Scene) else leaves


def fd_check(
    loss_fn: Callable[[Any], torch.Tensor],
    params,
    *,
    leaves: list[str] | None = None,
    eps: float = 1e-3,
    rtol: float = 1e-2,
    atol: float = 1e-6,
    probes_per_leaf: int = 8,
    seed: int = 0,
) -> Mapping[str, Any]:
    """Check autograd's gradient of ``loss_fn`` against central differences.

    ``params`` is a :class:`Scene` (its leaves named as
    :data:`~raytracingc_tpu_torch.scene.types.LEAF_PATHS`) or a dict of
    named float tensors; ``loss_fn`` takes the same kind. ``leaves``
    restricts the check to names containing one of these substrings
    (``None``: every leaf). Returns ``{name: {"pass", "total", "probes"},
    "pass_rate": ...}``.
    """
    named = _named(params)
    picked = [k for k, t in named.items() if t.is_floating_point()
              and (leaves is None or any(s in k for s in leaves))]
    grad_in = {k: t.detach().clone().requires_grad_(k in picked)
               for k, t in named.items()}
    loss_fn(_rebuild(params, grad_in)).backward()
    rng = np.random.default_rng(seed)

    results: dict[str, Any] = {}
    n_pass = n_total = 0
    with torch.no_grad():
        for name in picked:
            leaf = named[name].detach()
            g = grad_in[name].grad
            g = torch.zeros_like(leaf) if g is None else g
            leaf_pass, rows = 0, []
            for _ in range(probes_per_leaf):
                v = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
                norm = np.linalg.norm(v)
                if norm > 0:
                    v /= norm
                v = torch.from_numpy(v).to(leaf.device)

                def shift(h):
                    return _rebuild(params, {**named, name: leaf + h * v})

                fd = float((loss_fn(shift(+eps)) - loss_fn(shift(-eps))) / (2.0 * eps))
                an = float((g * v).sum())
                ok = abs(fd - an) <= atol + rtol * max(abs(fd), abs(an))
                leaf_pass += ok
                rows.append((fd, an, ok))
            results[name] = {"pass": leaf_pass, "total": probes_per_leaf,
                             "probes": rows}
            n_pass += leaf_pass
            n_total += probes_per_leaf
    results["pass_rate"] = n_pass / max(n_total, 1)
    return results


def pixel_grad_check(scene: Scene, camera, width: int = 16, height: int = 16,
                     spp: int = 2, max_bounce: int = 3, seed: int = 0,
                     leaves: list[str] | None = None,
                     **kwargs) -> Mapping[str, Any]:
    """FD-check the gradients of a rendered-image loss w.r.t. scene leaves.

    The loss is a fixed random projection of the linear radiance image,
    ``mean(radiance * w)`` with ``w`` standard normal from a
    ``torch.Generator`` seeded with ``seed``, so every pixel weighs
    differently and no cancellation can hide an error. Default leaves: the
    smooth material and environment parameters (geometry enters mostly
    through visibility; name it explicitly, e.g. ``["triangles"]``). The
    scene's accel is not a parameter: it stays attached unchanged.
    """
    from raytracingc_tpu_torch.camera import primary_rays
    from raytracingc_tpu_torch.render.integrator import trace_accumulate

    if leaves is None:
        leaves = ["albedo", "emission", "smoothness", "env"]
    dev = scene.device
    origins, dirs = primary_rays(camera.to(dev), width, height)
    ray_ids = torch.arange(width * height, device=dev)
    w = torch.randn((width * height, 3), generator=torch.Generator().manual_seed(seed))
    w = w.to(dev)

    def loss_fn(s):
        radiance, _ = trace_accumulate(origins, dirs, s, ray_ids, seed=seed,
                                       spp=spp, max_bounce=max_bounce)
        return (radiance * w).mean()

    return fd_check(loss_fn, scene, leaves=leaves, **kwargs)
