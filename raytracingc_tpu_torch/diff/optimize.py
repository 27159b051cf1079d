"""Inverse rendering: fit scene parameters or the camera pose to a target image.

Counterpart of ``raytracingc_tpu/diff/optimize.py``: render, L2 loss against
the target, autograd's gradients w.r.t. the named scene leaves (vertices,
materials, environment) or the camera pose, and an Adam step
(``torch.optim.Adam`` in place of ``optax.adam``; the same update rule).
Each loss runs the integrator's differentiable fast forward
(``trace_accumulate(early_exit=False, compact=True)``); the search runs on
the card's kernels under ``torch.no_grad``.

``fit_scene(checkpoint_path=)`` snapshots the scene (with its accel) and
the optimizer's ``state_dict()`` through ``utils/checkpoint.py`` and resumes
from them. Each step of ``fit_scene`` is ``parallel.sharded.make_train_step``'s,
on one device or, with ``mesh=``, across the mesh's ranks.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from raytracingc_tpu_torch.camera import Camera, look_at_basis, primary_rays
from raytracingc_tpu_torch.ops.accel import build_accel
from raytracingc_tpu_torch.parallel.mesh import mesh_device
from raytracingc_tpu_torch.parallel.sharded import make_train_step
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.scene.types import Scene, scene_leaves, with_leaves
from raytracingc_tpu_torch.utils.checkpoint import load_pytree, save_pytree

Grads = Mapping[str, torch.Tensor]

# The geometry leaves among the scene's named leaves.
_GEOM_LEAF_PATHS = (".triangles.a", ".triangles.b", ".triangles.c",
                    ".triangles.normal")


def leaf_filter(trainable: Sequence[str]) -> Callable[[Grads], dict]:
    """Gradient filter zeroing every leaf whose name contains none of the
    substrings: ``leaf_filter(["albedo"])`` trains albedo only."""

    def apply(grads: Grads) -> dict:
        return {k: g if any(s in k for s in trainable) else torch.zeros_like(g)
                for k, g in grads.items()}

    return apply


def is_geometry_trained(trainable: Sequence[str] | None) -> bool:
    """Would ``leaf_filter(trainable)`` pass gradients to a geometry leaf?

    The same forward substring rule as :func:`leaf_filter` (pattern in the
    full leaf name), so ``["triangles.albedo"]`` is not geometry although
    ".triangles.a" is a prefix of its name.
    """
    return trainable is None or any(
        t in g for t in trainable for g in _GEOM_LEAF_PATHS
    )


def _adam(params, learning_rate):
    return torch.optim.Adam(params, lr=learning_rate)


def _prime(opt: torch.optim.Optimizer) -> None:
    """Give every parameter the state a first step creates (a step on zero
    gradients), so that ``opt.state_dict()`` has the structure of a saved
    one. The caller overwrites the parameters and the state afterwards."""
    for group in opt.param_groups:
        for p in group["params"]:
            p.grad = torch.zeros_like(p)
    opt.step()
    opt.zero_grad(set_to_none=True)


def _check_finite(losses, who):
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"{who} produced non-finite losses")


def fit_camera(scene: Scene, target: torch.Tensor, camera: Camera, *,
               steps: int = 250, learning_rate: float = 1e-2, spp: int = 2,
               max_bounce: int = 2, seed: int = 0, backend: str = "auto",
               optimizer: Callable | None = None) -> tuple[Camera, list[float]]:
    """Recover the camera pose (origin and view direction) from image loss.

    The parameters are the origin and the unit view direction (``ez``),
    as in the JAX package: the look-at point's distance along the view is
    pure gauge. ``fov`` stays frozen. ``optimizer`` is a factory
    ``params -> torch.optim.Optimizer`` (default Adam at ``learning_rate``).
    Returns ``(fitted camera, losses)``, each loss taken before its step.
    """
    dev = scene.device
    height, width = int(target.shape[0]), int(target.shape[1])
    tgt = target.reshape(-1, 3).to(dev)
    camera = camera.to(dev)
    ray_ids = torch.arange(width * height, device=dev)
    params = {"origin": camera.origin.detach().clone().requires_grad_(True),
              "dir": camera.ez.detach().clone().requires_grad_(True)}
    opt = (optimizer or (lambda ps: _adam(ps, learning_rate)))(list(params.values()))

    def build(p) -> Camera:
        x, y, z = p["dir"].unbind(-1)
        dn = p["dir"] / torch.sqrt(x * x + y * y + z * z)
        ex, ey, ez = look_at_basis(p["origin"], p["origin"] + dn)
        return Camera(origin=p["origin"], ex=ex, ey=ey, ez=ez, fov=camera.fov)

    losses: list[float] = []
    for _ in range(steps):
        o, d = primary_rays(build(params), width, height)
        radiance, _ = trace_accumulate(o, d, scene, ray_ids, seed=seed, spp=spp,
                                       max_bounce=max_bounce, backend=backend)
        loss = ((radiance - tgt) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    _check_finite(losses, "fit_camera")
    with torch.no_grad():
        return build({k: t.detach() for k, t in params.items()}), losses


def fit_scene(
    scene: Scene,
    target: torch.Tensor,  # [H, W, 3] linear radiance
    camera: Camera,
    *,
    steps: int = 100,
    learning_rate: float = 1e-2,
    spp: int = 4,
    max_bounce: int = 3,
    seed: int = 0,
    backend: str = "auto",
    trainable: Sequence[str] | None = None,
    param_filter: Callable[[Grads], Grads] | None = None,
    optimizer: Callable | None = None,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 50,
    resume: bool = True,
    log_every: int = 0,
    accel_rebuild_every: int = 0,
) -> tuple[Scene, list[float]]:
    """Gradient-descent loop fitting the scene's leaves to ``target``.

    ``trainable`` restricts the updates to leaves whose name contains one
    of the substrings (``["albedo"]``; ``None``: every leaf);
    ``param_filter`` (a function on the ``{name: grad}`` dict) overrides
    it. ``optimizer`` is a factory ``params -> torch.optim.Optimizer``
    (default Adam at ``learning_rate``). Returns ``(fitted scene, losses)``,
    each loss taken before its step.

    ``checkpoint_path`` saves ``(scene, optimizer.state_dict())`` with
    ``step=i`` after every ``checkpoint_every``-th step ``i`` and once at the
    end (``step=steps-1``); the saved scene carries the accel the next step
    would refresh. With ``resume`` an existing checkpoint restarts the loop
    at its step + 1, and ``losses`` holds only the steps run. A resume
    primes the optimizer with one step on zero gradients before loading its
    state, so it supports optimizers whose ``step()`` takes no closure.

    Geometry training keeps the accel's culling: each step's search runs
    against :func:`refresh_accel` of the current triangles on the accel's
    static Morton order, exact at every step; ``accel_rebuild_every=k``
    re-sorts that order on the host every k steps (0: never), which only
    restores culling quality. Material-only training keeps the accel as it
    is. The returned scene carries an accel rebuilt for the fitted geometry
    (geometry trained) or the original one.

    ``mesh`` (a ``parallel.mesh.make_mesh`` mesh; every rank calls
    ``fit_scene`` with the same arguments) shards each step's rays and
    samples over the ranks (``make_train_step``); each rank trains its
    replica on its own device (``parallel.mesh.rank_device``), and rank 0
    alone writes checkpoints and logs.
    """
    dev = scene.device if mesh is None else mesh_device(mesh)
    scene = scene.to(dev)
    leader = mesh is None or dist.get_rank() == 0
    height, width = int(target.shape[0]), int(target.shape[1])
    tgt = target.reshape(-1, 3).to(dev)
    origins, dirs = primary_rays(camera.to(dev), width, height)
    ray_ids = torch.arange(width * height, device=dev)

    geometry_trained = is_geometry_trained(trainable)
    accel = scene.accel
    can_refresh = (geometry_trained and accel is not None
                   and accel.perm_of_orig is not None)
    trains = (lambda k: True) if trainable is None or param_filter is not None \
        else (lambda k: any(s in k for s in trainable))
    params = {k: t.detach().clone().requires_grad_(trains(k))
              for k, t in scene_leaves(scene).items()}
    opt = (optimizer or (lambda ps: _adam(ps, learning_rate)))(
        [t for t in params.values() if t.requires_grad])
    step = make_train_step(mesh, opt, spp=spp, max_bounce=max_bounce,
                           backend=backend, seed=seed, param_filter=param_filter,
                           geometry_trainable=geometry_trained)

    def snapshot():
        """What a checkpoint holds: the current scene with the accel the
        next step refreshes, and the optimizer's state."""
        s = with_leaves(scene, {k: t.detach() for k, t in params.items()})
        return dataclasses.replace(s, accel=accel), opt.state_dict()

    start = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        _prime(opt)
        (saved_scene, opt_state), saved = load_pytree(checkpoint_path, snapshot())
        with torch.no_grad():
            for k, t in scene_leaves(saved_scene).items():
                params[k].copy_(t)
        opt.load_state_dict(opt_state)
        accel = saved_scene.accel
        start = (saved or 0) + 1

    losses: list[float] = []
    # The step refreshes a host-built accel against the current triangles
    # and returns it refreshed against the updated ones, which the next step
    # takes as it is; a geometry-trained scene whose accel cannot follow the
    # vertices (a trivial accel) runs without one.
    current = dataclasses.replace(
        scene, accel=None if geometry_trained and not can_refresh else accel)
    for i in range(start, steps):
        current, loss = step(current, params, origins, dirs, ray_ids, tgt)
        losses.append(loss)
        if (can_refresh and accel_rebuild_every
                and (i + 1) % accel_rebuild_every == 0 and (i + 1) < steps):
            with torch.no_grad():
                accel = build_accel(with_leaves(scene, params).triangles,
                                    scene.n_triangles)
            current = dataclasses.replace(current, accel=accel)
        if leader and log_every and i % log_every == 0:
            print(f"[fit_scene] step {i}: loss {losses[-1]:.6g}")
        if (leader and checkpoint_path and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            save_pytree(checkpoint_path, snapshot(), step=i)
    if leader and checkpoint_path and steps > start:
        save_pytree(checkpoint_path, snapshot(), step=steps - 1)
    _check_finite(losses, "fit_scene")
    fitted = with_leaves(scene, {k: t.detach() for k, t in params.items()})
    if scene.accel is not None and geometry_trained:
        # The accel holds its own copy of the geometry: rebuild it for the
        # moved vertices.
        fitted = fitted.with_accel()
    return fitted, losses
