"""Top-level rendering entry points.

Counterpart of ``raytracingc_tpu/render/renderer.py``. :func:`render`:
primary rays for every pixel, padded to a multiple of ``pixel_chunk`` with
dead rays, and traced chunk by chunk through the integrator (by default its
production mode) so that device memory stays bounded at any resolution;
:func:`trace_rays` is that chunk loop on any rays (a sharded render's
shard). :func:`render_image`: the same, tonemapped to bytes and optionally
written. Each call of :func:`render` or :func:`trace_rays` is one
``rtc.render`` span (``call``: its number in the process) holding an
``rtc.chunk`` span for each chunk.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.render.image import tonemap_to_bytes, write_image
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.scene.types import Scene
from raytracingc_tpu_torch.utils.profiling import trace_annotation

# Numbers the process's render calls (the rtc.render span's ``call``).
_calls = itertools.count()


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def default_pixel_chunk(n_pix: int) -> int:
    """Pixels per chunk: the image rounded up to 1024, at most 65,536 (the
    JAX package's measured value, kept as the starting point)."""
    return int(min(max(_round_up(n_pix, 1024), 1024), 65536))


def pad_rays(origins, dirs, ray_ids, multiple: int):
    """Pad rays to a multiple of ``multiple`` with dead rays: ``(origins,
    dirs, ray_ids, active)``. A padding ray starts at 0 with the unit
    direction +z, so the math stays finite, and ``active`` keeps it dead (no
    radiance, no count)."""
    n = origins.shape[0]
    pad = _round_up(n, multiple) - n
    active = torch.arange(n + pad, device=origins.device) < n
    if pad:
        origins = torch.cat([origins, origins.new_zeros((pad, 3))])
        pad_dirs = dirs.new_zeros((pad, 3))
        pad_dirs[:, 2] = 1.0
        dirs = torch.cat([dirs, pad_dirs])
        ray_ids = torch.cat([ray_ids, ray_ids.new_zeros(pad)])
    return origins, dirs, ray_ids, active


def trace_rays(scene: Scene, origins, dirs, ray_ids, spp: int, max_bounce: int,
               active=None, seed: int = 0, backend: str = "auto",
               pixel_chunk: int | None = None, early_exit: bool = True,
               sample_offset: int = 0, compact: bool = True, sample_batch=1,
               sample_group=1):
    """Trace ``spp`` samples of each given ray, chunk by chunk: ``(radiance
    [R, 3], rays_traced)``. The rays are padded to a multiple of
    ``pixel_chunk`` (default :func:`default_pixel_chunk` of ``R``) with dead
    rays; lanes with ``active=False`` stay dead too. A lane's radiance does
    not depend on the chunking; the keywords are :func:`render`'s."""
    with trace_annotation("rtc.render", call=next(_calls)):
        return _trace_chunks(scene, origins, dirs, ray_ids, spp, max_bounce,
                             active, seed, backend, pixel_chunk, early_exit,
                             sample_offset, compact, sample_batch, sample_group)


def _trace_chunks(scene, origins, dirs, ray_ids, spp, max_bounce, active, seed,
                  backend, pixel_chunk, early_exit, sample_offset, compact,
                  sample_batch, sample_group):
    """:func:`trace_rays`' chunk loop, inside the caller's span."""
    n = origins.shape[0]
    if pixel_chunk is None:
        pixel_chunk = default_pixel_chunk(n)
    if pixel_chunk < 1:
        raise ValueError(f"pixel_chunk must be >= 1, got {pixel_chunk}")
    origins, dirs, ray_ids, live = pad_rays(origins, dirs, ray_ids, pixel_chunk)
    if active is not None:
        live[:n] &= active

    radiance, count = [], 0
    for lo in range(0, origins.shape[0], pixel_chunk):
        hi = lo + pixel_chunk
        with trace_annotation("rtc.chunk"):
            rad, cnt = trace_accumulate(
                origins[lo:hi], dirs[lo:hi], scene, ray_ids[lo:hi], seed=seed,
                spp=spp, max_bounce=max_bounce, backend=backend,
                sample_offset=sample_offset, active=live[lo:hi],
                early_exit=early_exit, sample_batch=sample_batch, compact=compact,
                sample_group=sample_group,
            )
        radiance.append(rad)
        count += cnt
    return torch.cat(radiance)[:n], count


def render(scene: Scene, camera: Camera, width: int, height: int, spp: int,
           max_bounce: int, seed: int = 0, backend: str = "auto",
           pixel_chunk: int | None = None, early_exit: bool = True,
           sample_offset: int = 0, compact: bool = True, sample_batch=1,
           sample_group=1, device=None):
    """Render linear radiance: ``(image [H, W, 3] float32, rays_traced)``.

    ``device`` defaults to the scene's; the scene and camera are moved there.
    ``rays_traced`` is an exact Python integer (under ``torch.func.vmap``,
    an int64 tensor per element where the elements' paths differ). A lane's
    radiance does not depend on ``pixel_chunk``. ``early_exit``, ``compact``, ``sample_batch``
    and ``sample_group`` select the integrator's mode
    (:func:`~raytracingc_tpu_torch.render.integrator.trace_accumulate`):
    the default is the forward-only production mode; pass
    ``early_exit=False`` when differentiating.
    """
    with trace_annotation("rtc.render", call=next(_calls)):
        device = torch.device(device) if device is not None else scene.device
        scene, camera = scene.to(device), camera.to(device)
        origins, dirs = primary_rays(camera, width, height)
        ray_ids = torch.arange(width * height, dtype=torch.int64, device=device)
        radiance, count = _trace_chunks(
            scene, origins, dirs, ray_ids, spp, max_bounce, None, seed, backend,
            pixel_chunk, early_exit, sample_offset, compact, sample_batch,
            sample_group)
        return radiance.reshape(height, width, 3), count


def render_image(scene: Scene, camera: Camera, width: int, height: int,
                 spp: int, max_bounce: int, seed: int = 0,
                 backend: str = "auto", output: str | None = None,
                 pixel_chunk: int | None = None) -> np.ndarray:
    """Render and tonemap to uint8 ``[H, W, 3]`` (and optionally write a
    BMP or PNG file, by ``output``'s extension)."""
    linear, _ = render(scene, camera, width, height, spp, max_bounce,
                       seed=seed, backend=backend, pixel_chunk=pixel_chunk)
    img = tonemap_to_bytes(linear.cpu().numpy())
    if output is not None:
        write_image(output, img)
    return img
