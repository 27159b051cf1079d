"""One tiny sharded training step and three sharded renders on every rank.

Counterpart of ``__graft_entry__.py::dryrun_multichip``, on a scene that
carries an accel (box_scene tessellated), so that the step refreshes it.
Every rank of an initialised world calls it
(``parallel.mesh.initialize_distributed`` first);
``tests/test_torch_parallel.py`` runs it on 4 ranks of a gloo world.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.parallel.mesh import (
    make_mesh,
    rank_device,
    world_size,
)
from raytracingc_tpu_torch.parallel.sharded import (
    make_train_step,
    mesh_for_strategy,
    pad_scene_for_blocks,
    render_sharded,
    strategy_spp_dim,
)
from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt, tessellate
from raytracingc_tpu_torch.scene.types import scene_leaves

BOX_SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "examples", "box_scene.txt")


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """In a world of ``n_devices`` ranks: one Adam step of
    :func:`make_train_step` on a ``(px, spp)`` mesh (``spp`` 2 where the
    ranks divide by 2) against a sharded render of box_scene tessellated
    once (40 triangles) with its accel, then the trained scene rendered on the
    px-only mesh, replicated and block-sharded, the two bit for bit equal.
    Raises on a non-finite loss or image or a broken identity; returns
    ``{"loss", "rays", "blocks_rays"}``."""
    if world_size(device_type) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                         f"{world_size(device_type)} ranks")
    spp_dim = strategy_spp_dim("both", n_devices)
    mesh = make_mesh(px=n_devices // spp_dim, spp=spp_dim, device_type=device_type)
    dev = rank_device(device_type)
    scene = scene_from_triangles_txt(BOX_SCENE)
    tris, n_live = tessellate(scene.triangles, scene.n_triangles, levels=1)
    scene = dataclasses.replace(scene, triangles=tris, n_triangles=n_live,
                                accel=None).with_accel().to(dev)
    cam = Camera.look_at(device=dev)
    width = height = 16
    spp = 2 * spp_dim
    origins, dirs = primary_rays(cam, width, height)
    ray_ids = torch.arange(width * height, device=dev)

    target, _ = render_sharded(scene, cam, width, height, spp=spp, max_bounce=2,
                               mesh=mesh)
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in scene_leaves(scene).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    step = make_train_step(mesh, opt, spp=spp, max_bounce=2, seed=7)
    trained, loss = step(scene, params, origins, dirs, ray_ids,
                         target.reshape(-1, 3) * 0.9)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss from the sharded train step: {loss}")
    if trained.accel is None or trained.accel.packed_plane is None:
        raise AssertionError("the trained scene lost its refreshed accel")

    px_mesh = mesh_for_strategy("pixels", n_devices, device_type)
    img, rays = render_sharded(trained, cam, width, height, spp=2, max_bounce=2,
                               mesh=px_mesh)
    if not torch.isfinite(img).all():
        raise AssertionError("non-finite radiance from the px-only mesh")
    padded = pad_scene_for_blocks(trained, n_devices)
    blk, blk_rays = render_sharded(padded, cam, width, height, spp=2,
                                   max_bounce=2, mesh=px_mesh,
                                   scene_sharding="blocks")
    ref, ref_rays = render_sharded(padded, cam, width, height, spp=2,
                                   max_bounce=2, mesh=px_mesh)
    if blk_rays != ref_rays or not torch.equal(blk.view(torch.int32),
                                               ref.view(torch.int32)):
        raise AssertionError("the block-sharded render is not the replicated "
                             "render's bits")
    return {"loss": loss, "rays": rays, "blocks_rays": blk_rays}

