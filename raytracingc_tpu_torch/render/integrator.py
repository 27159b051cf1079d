"""Path-tracing integrator: the production forward mode.

Counterpart of ``raytracingc_tpu/render/integrator.py`` with
``trace_accumulate(early_exit=True, compact=True)``. One Monte-Carlo sample
follows the reference ``calcColor``: on a hit the ray scatters to
``lerp(normalize(normal + random_unit), reflect(dir, normal), smoothness)``,
emission is added weighted by the throughput BEFORE the albedo multiply, and
Russian roulette on ``p = max(throughput)`` ends the path or renormalizes by
``1/p``; on a miss the environment light is added and the path ends.

The JAX package works at fixed widths (a while-loop tier cascade at /4, /16,
/64 and hit-front entry widths R/8, R/4), because XLA needs static shapes.
Here each bounce runs on exactly the live lanes, found with
``torch.nonzero``. Per-lane arithmetic, the RNG draw order (6 draws for the
unit vector, then 1 for roulette) and the ``light0*spp + sum_s(rest_s)``
association are those of the JAX package, so a lane's radiance does not
depend on chunking or on which lanes were compacted with it.

Traced rays are counted as Python integers (exact at any size; the JAX
package sums them in float32).
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch import rng
from raytracingc_tpu_torch.ops.env_light import environment_light
from raytracingc_tpu_torch.ops.intersect import (
    Hit,
    nearest_hit,
    resolve_hit,
    with_perm_resolve,
)
from raytracingc_tpu_torch.scene.types import Scene


def _normalize(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    norm = torch.sqrt(x * x + y * y + z * z)
    return v / torch.clamp_min(norm, 1e-12)[:, None]


def _reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection."""
    dn = d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1] + d[:, 2] * n[:, 2]
    return d - 2.0 * dn[:, None] * n


def _live(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the True lanes, in order (a host sync)."""
    return torch.nonzero(mask).squeeze(1)


def trace_paths(origins, dirs, rng_state, scene: Scene, max_bounce: int,
                backend: str = "auto", active=None, throughput0=None):
    """Trace one sample per ray. Returns ``(radiance [R, 3], rays_traced)``.

    Lanes with ``active=False`` are dead from the start. Each bounce runs on
    the live lanes only and stops once none is left (the early-exit loop);
    ``rays_traced`` counts one ray per live lane per bounce.
    """
    r = origins.shape[0]
    dev = origins.device
    light_full = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    lanes = (torch.arange(r, device=dev) if active is None else _live(active))
    thr = (torch.ones((r, 3), dtype=torch.float32, device=dev)
           if throughput0 is None else throughput0)
    pos, d, thr, state = origins[lanes], dirs[lanes], thr[lanes], rng_state[lanes]
    light = torch.zeros((lanes.numel(), 3), dtype=torch.float32, device=dev)
    count = 0

    for _ in range(max_bounce):
        n = lanes.numel()
        if n == 0:
            break
        count += n
        hit = resolve_hit(pos, d, nearest_hit(pos, d, scene, backend=backend), scene)

        # Scatter (every lane here is alive).
        state, unit = rng.next_unit_vector(state)
        diffuse = _normalize(hit.normal + unit)
        specular = _reflect(d, hit.normal)
        smooth = hit.smoothness[:, None]
        new_dir = (1.0 - smooth) * diffuse + smooth * specular

        # Emission weighted by the PRE-update throughput, then albedo.
        hm = hit.hit[:, None]
        emitted = hit.albedo * hit.emission[:, None]
        light = light + torch.where(hm, emitted * thr, 0.0)
        new_thr = thr * hit.albedo

        # Russian roulette: survive iff p >= u.
        state, u_rr = rng.next_uniform(state)
        p = new_thr.amax(dim=-1)
        survive = p >= u_rr
        new_thr = new_thr / torch.where(p > 0.0, p, 1.0)[:, None]

        # Miss: add the environment light and end the path.
        env = environment_light(d, scene.env)
        light = light + torch.where(~hm, env * thr, 0.0)

        thr = torch.where(hm, new_thr, thr)
        pos = torch.where(hm, hit.point, pos)
        d = torch.where(hm, new_dir, d)
        alive = hit.hit & survive

        light_full[lanes] = light
        keep = _live(alive)
        if keep.numel() < n:
            lanes, pos, d, thr, state, light = (
                x[keep] for x in (lanes, pos, d, thr, state, light)
            )
    return light_full, count


_NOT_PORTED_MODES = (
    "only the production forward mode (early_exit=True, compact=True, "
    "sample_batch=1, sample_group=1) is ported; the other integrator modes "
    "wait for ROADMAP Queue 1 item 4b"
)


def trace_accumulate(origins, dirs, scene: Scene, ray_ids, seed: int, spp: int,
                     max_bounce: int, backend: str = "auto",
                     sample_offset: int = 0, active=None,
                     early_exit: bool = True, sample_batch=1,
                     compact: bool = True, sample_group=1):
    """Average ``spp`` samples per ray: ``(radiance [R, 3], rays_traced)``.

    Each sample has its own RNG stream keyed by (seed, ray_id, sample_id),
    ``sample_id`` running from ``sample_offset``. Only the production mode is
    ported; other modes raise ``NotImplementedError``. The Morton-permuted
    resolve table is attached once here (``with_perm_resolve``).
    """
    if not (early_exit and compact and sample_batch == 1 and sample_group == 1):
        raise NotImplementedError(
            f"early_exit={early_exit}, compact={compact}, "
            f"sample_batch={sample_batch}, sample_group={sample_group}: "
            + _NOT_PORTED_MODES
        )
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    scene = with_perm_resolve(scene)
    r = origins.shape[0]
    if max_bounce < 1:
        return torch.zeros((r, 3), dtype=torch.float32, device=origins.device), 0
    act = (torch.ones((r,), dtype=torch.bool, device=origins.device)
           if active is None else active)
    # Primary hits are the same for every sample: search and resolve once.
    hit0 = resolve_hit(
        origins, dirs, nearest_hit(origins, dirs, scene, backend=backend, alive=act),
        scene,
    )
    return _hit_front_accumulate(
        origins, dirs, scene, ray_ids, seed, sample_offset, spp, max_bounce,
        backend, act, hit0,
    )


def _hit_front_accumulate(origins, dirs, scene, ray_ids, seed, offset, spp,
                          max_bounce, backend, act, hit0: Hit):
    """Sample accumulation with the primary hits compacted once per chunk.

    The bounce-0 radiance (emission on hit lanes, environment light on miss
    lanes, throughput 1) is the same for every sample, so it is computed once
    and weighted by ``spp``. Each sample's continuation (scatter, roulette,
    bounces 1..N-1) runs on the primary-hit lanes only, and the per-lane
    result is ``light0 * spp + sum_s(rest_s)``, then divided by ``spp``.
    """
    r = origins.shape[0]
    hitm = hit0.hit & act
    emitted = hit0.albedo * hit0.emission[:, None]
    env = environment_light(dirs, scene.env)
    light0 = (torch.where(hitm[:, None], emitted, 0.0)
              + torch.where((act & ~hit0.hit)[:, None], env, 0.0))
    count = int(act.sum()) * spp

    sel = _live(hitm)
    point, normal, albedo = hit0.point[sel], hit0.normal[sel], hit0.albedo[sel]
    smooth = hit0.smoothness[sel][:, None]
    ids = ray_ids[sel]
    # Post-bounce-0 throughput is deterministic: albedo / p with
    # p = max(albedo) (the roulette renorm); only survival is random.
    p = albedo.amax(dim=-1)
    thr = albedo / torch.where(p > 0.0, p, 1.0)[:, None]
    spec = _reflect(dirs[sel], normal)

    acc = torch.zeros((sel.numel(), 3), dtype=torch.float32, device=origins.device)
    if sel.numel() and max_bounce > 1:  # else the continuation traces nothing
        for s in range(spp):
            state = rng.stream_init(seed, ids, offset + s)
            # Same draw order as a full bounce: 6 for the unit vector, 1 for
            # roulette.
            state, unit = rng.next_unit_vector(state)
            diffuse = _normalize(normal + unit)
            new_dir = (1.0 - smooth) * diffuse + smooth * spec
            state, u_rr = rng.next_uniform(state)
            light_s, cnt = trace_paths(
                point, new_dir, state, scene, max_bounce - 1, backend=backend,
                active=p >= u_rr, throughput0=thr,
            )
            acc = acc + light_s
            count += cnt

    contrib = torch.zeros((r, 3), dtype=torch.float32, device=origins.device)
    contrib[sel] = acc
    return (light0 * float(spp) + contrib) / float(spp), count
