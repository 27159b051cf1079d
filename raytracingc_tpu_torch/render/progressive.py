"""Progressive rendering with sample-batch checkpoints.

Counterpart of ``raytracingc_tpu/render/progressive.py``. The spp axis is
split into batches with disjoint sample-id ranges (``render(...,
sample_offset=done)``: the counter-based RNG gives batch k the same streams
whether or not batches 0..k-1 ran in the same process), and the running
radiance sum is snapshotted atomically after each batch. A stopped job
resumes at the next batch boundary with output bit-identical to the same
progressive run uninterrupted. Against a one-shot render of the same total
spp, per-sample radiances are identical but the final average
re-associates float additions (each batch's mean is de-averaged and
re-summed), so the two agree to re-association (~2e-6 relative), not
bit for bit.

The checkpoint is the pair ``(acc, count)``: ``acc`` the ``[H, W, 3]``
float32 radiance sum, ``count`` the traced rays, with ``__step__`` the
samples done. The port keeps ``count`` exact as an int64 where the JAX
package sums it in float32; the leaf order is the same, so either
package's checkpoint loads in the other (the count's value is exact in
both while it is below 2**24).

With ``mesh`` or ``shard_strategy`` each batch renders across the ranks
through ``parallel.sharded.render_sharded`` (every rank holds the whole
image), and rank 0 alone writes the checkpoint.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist

from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.parallel.mesh import mesh_device, mesh_shape
from raytracingc_tpu_torch.parallel.sharded import mesh_for_strategy, render_sharded
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.types import Scene
from raytracingc_tpu_torch.utils.checkpoint import load_pytree, save_pytree


def _sg_int(sample_group) -> int:
    """Divisor for the per-batch check ("auto" divides every batch: the
    integrator resolves it per batch)."""
    return 1 if sample_group == "auto" else int(sample_group)


def render_progressive(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    *,
    batch_spp: int = 64,
    seed: int = 0,
    backend: str = "auto",
    checkpoint_path: str | None = None,
    resume: bool = True,
    on_batch: Callable[[int, int, torch.Tensor], None] | None = None,
    mesh=None,
    shard_strategy: str | None = None,
    sample_group: int | str = 1,
    device=None,
) -> tuple[torch.Tensor, int]:
    """Render ``spp`` samples in batches of ``batch_spp``, checkpointing
    ``(acc, count)`` after each batch when ``checkpoint_path`` is given.

    Returns ``(image [H, W, 3] linear, rays_traced)``, equal to
    :func:`~raytracingc_tpu_torch.render.renderer.render` with the same
    total spp and seed up to re-association of the sample average (module
    docstring); ``rays_traced`` is an exact Python integer. With ``resume``
    an existing checkpoint restarts the loop after its last batch.
    ``on_batch(done, total, partial_image)`` runs after each batch (progress
    bars, previews). A final partial batch that ``sample_group`` does not
    divide runs ungrouped. ``device`` defaults to the scene's; the scene and
    camera are moved there.

    ``mesh`` (a ``parallel.mesh.make_mesh`` mesh) or ``shard_strategy``
    (``"pixels"``, ``"samples"`` or ``"both"``: a mesh of the world's ranks
    on ``device``'s type, built once) renders each batch across the ranks,
    each rank on its own device (``parallel.mesh.rank_device``); with a
    ``spp`` dimension over 1 every batch, the final partial one and those
    after a resume included, must divide by it, which is checked before the
    first batch.
    """
    if batch_spp < 1:
        raise ValueError(f"batch_spp must be >= 1, got {batch_spp}")
    device = torch.device(device) if device is not None else scene.device
    sharded = mesh is not None or shard_strategy is not None
    if sharded:
        if mesh is None:
            mesh = mesh_for_strategy(shard_strategy, device_type=device.type)
        spp_dim = mesh_shape(mesh)[1]
        device = mesh_device(mesh)
    scene, camera = scene.to(device), camera.to(device)

    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    count, done = 0, 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        (acc, saved_count), saved = load_pytree(
            checkpoint_path, (acc, torch.zeros((), dtype=torch.int64)))
        count, done = int(saved_count), saved or 0
        if done > spp:
            raise ValueError(f"{checkpoint_path} holds {done} samples, more "
                             f"than spp={spp}")
    if sharded and spp_dim > 1:
        # The batches this loop will run, from the resume offset on.
        bad = sorted({min(batch_spp, spp - d) for d in range(done, spp, batch_spp)
                      if min(batch_spp, spp - d) % spp_dim})
        if bad:
            raise ValueError(
                f"samples sharding over {spp_dim} ranks needs every batch "
                f"divisible by {spp_dim}: got spp={spp}, batch_spp={batch_spp}, "
                f"resume offset {done} (offending batch sizes {bad}). Pick "
                f"batch_spp a multiple of {spp_dim} with spp % batch_spp also "
                f"a multiple, or shard by pixels.")
    writes = checkpoint_path and (not sharded or dist.get_rank() == 0)

    while done < spp:
        this = min(batch_spp, spp - done)
        kw = dict(spp=this, max_bounce=max_bounce, seed=seed, backend=backend,
                  sample_offset=done,
                  # The final partial batch may not divide the group: it runs
                  # ungrouped rather than erroring.
                  sample_group=(sample_group if this % _sg_int(sample_group) == 0
                                else 1))
        if sharded:
            img, c = render_sharded(scene, camera, width, height, mesh=mesh, **kw)
        else:
            img, c = render(scene, camera, width, height, **kw)
        acc = acc + img * float(this)  # de-average back to a sum
        count += c
        done += this
        if writes:
            save_pytree(checkpoint_path,
                        (acc, torch.tensor(count, dtype=torch.int64)), step=done)
        if on_batch is not None:
            on_batch(done, spp, acc / float(done))

    return acc / float(spp), count
