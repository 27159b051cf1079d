"""Path-tracing integrator: the production forward, the differentiable fast
forward, the plain full-width oracle, and the bounce-count heatmap.

Counterpart of ``raytracingc_tpu/render/integrator.py``. One Monte-Carlo
sample follows the reference ``calcColor``: on a hit the ray scatters to
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
depend on chunking or on which lanes were compacted with it. Every gather
and scatter on that path is out of place (``index_copy`` into a fresh
tensor), so the same code is reverse-differentiable under autograd: the
search runs under ``torch.no_grad`` and the resolve, shading, environment
light and camera carry the gradients (the visibility-frozen subgradient).
Forward mode (``torch.func.jvp``, ``torch.autograd.forward_ad``,
``torch.func.jacfwd``) runs through every mode, production included, on the
card's kernels too: the search wrappers carry no tangent
(``ops/no_tangent.py``). Under ``torch.func.vmap`` (over cameras, say) the
live lanes are those live in any element, masked per element, so each
element's values are its own call's bit for bit.

The resolve, the bounce step, the environment light and the RNG draws of
each bounce go through ``ops/shade.py``: on a card, where no derivative can
be seen, one CUDA kernel launch per call (``csrc/shade.cu``) with the torch
composition's bits (a block-sharded scene's resolve stays in torch);
otherwise the torch composition itself. On the same route the compactions
(the trace entry's, each bounce's and the hit front's selection) go through
``ops/compact.py``: one launch of ``csrc/compact.cu`` and one read of the
count each, the same lanes in the same order, into buffers allocated once a
call, the dead lanes' radiance written into the call's own image in place.

Traced rays are counted as Python integers (exact at any size; the JAX
package sums them in float32).

Spans (``utils/profiling.trace_annotation``): ``rtc.primary`` holds the
primary search and resolve, ``rtc.bounce`` each loop iteration that
searches, ``rtc.compact`` the live-lane selection (a host sync) with its
gathers and write-backs, ``rtc.shade`` the bounce body, the hit-front's
bounce-0 radiance (inside ``rtc.primary``, with the primary resolve) and its
continuations' streams, scatter and roulette (on the kernel route the
loop's fused resolve and step; the primary resolve's launch, with the
bounce-0 radiance, is ``rtc.resolve``). Counters: ``integrator.bounces`` one per search
made, ``integrator.lanes`` what is added to the returned count.

:func:`render_debug` is the reference's ``calcDebugColor``: the same walk
without Russian roulette, shading each pixel by its bounce count.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracingc_tpu_torch import rng
from raytracingc_tpu_torch.camera import primary_rays
from raytracingc_tpu_torch.ops import compact, shade
from raytracingc_tpu_torch.ops.intersect import (
    Hit,
    nearest_hit,
    resolve_hit,
    with_perm_resolve,
)
from raytracingc_tpu_torch.ops.no_tangent import lane_count, live_lanes
from raytracingc_tpu_torch.ops.shade import normalize as _normalize
from raytracingc_tpu_torch.ops.shade import reflect as _reflect
from raytracingc_tpu_torch.scene.types import Scene, scene_leaves
from raytracingc_tpu_torch.utils.profiling import COUNTS, tally, trace_annotation


def trace_paths(origins, dirs, rng_state, scene: Scene, max_bounce: int,
                backend: str = "auto", active=None, throughput0=None,
                first_hit: Hit | None = None):
    """Trace one sample per ray. Returns ``(radiance [R, 3], rays_traced)``.

    Lanes with ``active=False`` are dead from the start. ``first_hit``, the
    precomputed hit of (origins, dirs), serves bounce 0 at full width with no
    search (the JAX package's primary-hit cache). Every other bounce runs on
    the live lanes only and stops once none is left (the early-exit loop);
    ``rays_traced`` counts one ray per live lane per bounce. A lane's
    radiance is final once it dies, so it is written back when the live set
    shrinks and at the end.

    Under ``torch.func.vmap`` with a batched live mask, the lanes kept are
    those live in any element (``ops/no_tangent.live_lanes``) and each
    bounce masks the others, so every element gets its own values; the
    count is then an int64 tensor per element.
    """
    r = origins.shape[0]
    dev = origins.device
    light_full = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    thr = (torch.ones((r, 3), dtype=torch.float32, device=dev)
           if throughput0 is None else throughput0)
    pos, d, state, count = origins, dirs, rng_state, 0
    if first_hit is not None and max_bounce >= 1:
        alive = (torch.ones((r,), dtype=torch.bool, device=dev)
                 if active is None else active)
        count = tally("integrator.lanes", lane_count(alive))
        pos, d, thr, light_full, state, active = shade.step(
            pos, d, thr, light_full, state, first_hit, alive, scene)
        max_bounce -= 1

    kernel = compact.route(scene, pos, d, thr, light_full)
    with trace_annotation("rtc.compact"):
        compact.tally(kernel, r)
        if kernel:
            comp = compact.Buffers(r)
            mask = (torch.ones((r,), dtype=torch.bool, device=dev) if active is None
                    else active.contiguous())
            lanes, (pos, d, thr, state, light) = comp(
                mask, None, [x.contiguous() for x in (pos, d, thr, state, light_full)])
            union, alive = False, None
        else:
            lanes, union = ((torch.arange(r, device=dev), False) if active is None
                            else live_lanes(active))
            alive = active[lanes] if union else None
            pos, d, thr, state, light = (x[lanes] for x in (pos, d, thr, state,
                                                            light_full))
    for _ in range(max_bounce):
        n = lanes.numel()
        if n == 0:
            break
        with trace_annotation("rtc.bounce"):
            COUNTS["integrator.bounces"] += 1
            count += tally("integrator.lanes", n if alive is None else alive.sum())
            pos, d, thr, light, state, alive = shade.bounce(
                pos, d, thr, light, state,
                nearest_hit(pos, d, scene, backend=backend), alive, scene)
            with trace_annotation("rtc.compact"):
                compact.tally(kernel, n)
                if kernel:  # the dead lanes' radiance goes into light_full
                    lanes, (pos, d, thr, state, light) = comp(
                        alive, lanes, (pos, d, thr, state, light), (light, light_full))
                else:
                    keep, union = live_lanes(alive)
                    if keep.numel() < n:
                        light_full = light_full.index_copy(0, lanes, light)
                        lanes, pos, d, thr, state, light, alive = (
                            x[keep] for x in (lanes, pos, d, thr, state, light, alive)
                        )
            if not union:
                alive = None
    with trace_annotation("rtc.compact"):
        if kernel:  # light_full is this call's own: written in place
            return light_full.index_copy_(0, lanes, light), count
        return light_full.index_copy(0, lanes, light), count


def _trace_masked(origins, dirs, rng_state, scene: Scene, max_bounce: int,
                  backend, active, first_hit: Hit):
    """One sample per ray at full width, every lane through every bounce
    under an ``alive`` mask: the JAX package's fixed-length scan
    (``trace_paths`` with ``early_exit=False``), the plain oracle. Bounce 0
    uses the precomputed primary hit ``first_hit``. Returns ``(radiance
    [R, 3], rays_traced)``."""
    r = origins.shape[0]
    thr = torch.ones((r, 3), dtype=torch.float32, device=origins.device)
    count = tally("integrator.lanes", lane_count(active))
    pos, d, thr, light, state, alive = shade.step(
        origins, dirs, thr, torch.zeros_like(thr), rng_state, first_hit, active, scene)
    for _ in range(max_bounce - 1):
        with trace_annotation("rtc.bounce"):
            COUNTS["integrator.bounces"] += 1
            count += tally("integrator.lanes", lane_count(alive))
            pos, d, thr, light, state, alive = shade.bounce(
                pos, d, thr, light, state,
                nearest_hit(pos, d, scene, backend=backend, alive=alive), alive, scene)
    return light, count


def trace_accumulate(origins, dirs, scene: Scene, ray_ids, seed: int, spp: int,
                     max_bounce: int, backend: str = "auto",
                     sample_offset: int = 0, active=None,
                     early_exit: bool = False, sample_batch=1,
                     compact: bool = True, sample_group=1):
    """Average ``spp`` samples per ray: ``(radiance [R, 3], rays_traced)``.

    Each sample has its own RNG stream keyed by (seed, ray_id, sample_id),
    ``sample_id`` running from ``sample_offset``. Modes (``early_exit``,
    ``compact``), as in the JAX package:

    * ``(True, *)``: the production forward. No reverse mode: with grad
      enabled and any input requiring grad it raises ``ValueError`` naming
      the differentiable mode (JAX's ``while_loop`` refuses it too);
      forward mode works (``torch.func.jvp``, ``forward_ad``,
      ``torch.func.jacfwd``).
    * ``(False, True)``, the default: the differentiable fast forward, the
      same hit-front accumulation as production (values and counts equal
      bit for bit) under autograd.
    * ``(False, False)``: the plain full-width oracle, every lane through
      every bounce under a mask, associating ``sum_s(light0 + rest_s)``:
      equal to the others up to float re-association, counts equal.

    ``sample_group`` (an int dividing ``spp``, or ``"auto"``: the JAX rule,
    the largest divisor of ``spp`` up to ``65536 // (R // 8)``) traces that
    many samples of the hit-front continuation as one widened batch; per-lane
    values do not change. ``sample_batch`` (an int dividing ``spp``, or
    ``"auto"``: the largest of 8, 4, 2, 1 that divides it) widens the whole
    path instead: see :func:`_batch_accumulate`. The Morton-permuted resolve
    table is attached once here (``with_perm_resolve``).

    ``torch.func.vmap`` over any input (cameras' rays, scene leaves) gives
    each element the values of its own call bit for bit; ``rays_traced`` is
    then an int64 tensor per element wherever the live lanes differ between
    elements. tests/test_torch_jacfwd.py holds this for cameras on every
    search route (brute, bitmask, packed, range, words, mxu: the culling
    prelude runs on the batched rays) and for scene leaves on the brute
    route.
    """
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    # The JAX package's validation: a sample_group that cannot apply is
    # never silently ignored.
    if sample_group != 1 and sample_group != "auto":
        if spp % int(sample_group) != 0:
            raise ValueError(f"sample_group={sample_group} must divide spp={spp}")
        if not (early_exit or compact):
            raise ValueError(
                "sample_group>1 requires the hit-front accumulator "
                "(early_exit=True or compact=True); the plain fixed-length "
                "scan ignores it"
            )
        if sample_batch != 1:
            raise ValueError(
                "sample_group and sample_batch>1 are mutually exclusive "
                "(the widened sample_batch path bypasses the hit-front "
                "accumulator)"
            )
    if sample_batch == "auto":
        sample_batch = next(k for k in (8, 4, 2, 1) if spp % k == 0)
    if spp % sample_batch != 0:  # the JAX package's assert
        raise AssertionError((spp, sample_batch))
    if early_exit and torch.is_grad_enabled() and any(
            t.requires_grad for t in (origins, dirs, *scene_leaves(scene).values())):
        raise ValueError(
            "trace_accumulate(early_exit=True) is the forward-only production "
            "mode; for gradients use early_exit=False (with compact=True, the "
            "differentiable fast forward)"
        )
    scene = with_perm_resolve(scene)
    r = origins.shape[0]
    if max_bounce < 1:
        return torch.zeros((r, 3), dtype=torch.float32, device=origins.device), 0
    act = (torch.ones((r,), dtype=torch.bool, device=origins.device)
           if active is None else active)
    hit_front = sample_batch == 1 and (early_exit or compact)
    # Primary hits are the same for every sample: search and resolve once
    # (with the hit-front's bounce-0 radiance over its live hit lanes).
    with trace_annotation("rtc.primary"):
        COUNTS["integrator.bounces"] += 1
        ref = nearest_hit(origins, dirs, scene, backend=backend, alive=act)
        hitm = ref.hit & act if hit_front else None
        hit0, light0 = shade.primary(origins, dirs, ref, act, scene, hitm)
    if sample_batch > 1:
        return _batch_accumulate(origins, dirs, scene, ray_ids, seed,
                                 sample_offset, spp, max_bounce, backend, act,
                                 hit0, sample_batch, early_exit)
    if hit_front:
        if sample_group == "auto":
            cap = max(65536 // max(r // 8, 1), 1)
            sample_group = next(g for g in range(min(cap, spp), 0, -1)
                                if spp % g == 0)
        return _hit_front_accumulate(
            origins, dirs, scene, ray_ids, seed, sample_offset, spp, max_bounce,
            backend, act, hit0, hitm, light0, int(sample_group),
        )
    acc = torch.zeros((r, 3), dtype=torch.float32, device=origins.device)
    count = 0
    for s in range(spp):
        state = rng.stream_init(seed, ray_ids, sample_offset + s)
        rad, cnt = _trace_masked(origins, dirs, state, scene, max_bounce, backend,
                                 act, hit0)
        acc = acc + rad
        count += cnt
    return acc / float(spp), count


def _batch_accumulate(origins, dirs, scene, ray_ids, seed, offset, spp,
                      max_bounce, backend, act, hit0: Hit, batch: int,
                      early_exit: bool):
    """The JAX package's widened ``sample_batch`` path: ``batch`` samples of
    every ray traced as one ray batch of ``batch * R`` lanes (lane
    ``k * R + i`` is sample ``b * batch + k`` of ray ``i`` in batch ``b``),
    the primary hit tiled to that width. ``early_exit`` runs the early-exit
    loop (:func:`trace_paths` with ``first_hit``), else the masked full-width
    oracle (:func:`_trace_masked`), whatever ``compact`` says, as in the JAX
    package. Each batch's samples are summed, the batches added in order and
    the sum divided by ``spp``: ``sum_s(light0 + rest_s)``, the oracle's
    association."""
    r = origins.shape[0]
    widen = lambda x: x.repeat((batch,) + (1,) * (x.dim() - 1))
    o_w, d_w, ids_w, act_w = (widen(x) for x in (origins, dirs, ray_ids, act))
    hit_w = Hit(**{f.name: widen(getattr(hit0, f.name))
                   for f in dataclasses.fields(hit0)})
    lane_sample = torch.arange(batch, device=origins.device).repeat_interleave(r)
    trace = trace_paths if early_exit else _trace_masked
    acc = torch.zeros((r, 3), dtype=torch.float32, device=origins.device)
    count = 0
    for s in range(0, spp, batch):
        state = rng.stream_init(seed, ids_w, lane_sample + (offset + s))
        rad, cnt = trace(o_w, d_w, state, scene, max_bounce, backend,
                         act_w, first_hit=hit_w)
        acc = acc + rad.reshape(batch, r, 3).sum(0)
        count += cnt
    return acc / float(spp), count


def _hit_front_accumulate(origins, dirs, scene, ray_ids, seed, offset, spp,
                          max_bounce, backend, act, hit0: Hit, hitm, light0,
                          group: int):
    """Sample accumulation with the primary hits compacted once per chunk.

    The bounce-0 radiance (emission on hit lanes, environment light on miss
    lanes, throughput 1) is the same for every sample, so it is computed once
    and weighted by ``spp``. Each sample's continuation (scatter, roulette,
    bounces 1..N-1) runs on the primary-hit lanes only, ``group`` samples at
    a time as one batch (lane ``k * width + i`` is sample ``k`` of hit slot
    ``i``; the slices are added in sample order), and the per-lane result is
    ``light0 * spp + sum_s(rest_s)``, then divided by ``spp``. ``hitm`` is
    ``hit0.hit & act``; ``light0`` comes with ``hit0`` from the primary
    resolve.
    """
    r = origins.shape[0]
    count = tally("integrator.lanes", lane_count(act) * spp)

    kernel = compact.route(scene, origins, dirs, hit0.point, hit0.normal,
                           hit0.albedo, hit0.smoothness)
    with trace_annotation("rtc.compact"):
        compact.tally(kernel, r)
        if kernel:
            sel, (point, normal, albedo, smooth, ids, dirs_sel) = compact.Buffers(
                r, sets=1)(hitm, None, [x.contiguous() for x in (
                    hit0.point, hit0.normal, hit0.albedo, hit0.smoothness, ray_ids,
                    dirs)])
            width, smooth, hit_sel = sel.numel(), smooth[:, None], None
        else:
            sel, union = live_lanes(hitm)
            width = sel.numel()
            point, normal, albedo = hit0.point[sel], hit0.normal[sel], hit0.albedo[sel]
            smooth = hit0.smoothness[sel][:, None]
            ids = ray_ids[sel]
            # Under vmap, the primary-hit lanes of any element: a slot that
            # missed in this element stays dead.
            hit_sel = hitm[sel] if union else None
    # Post-bounce-0 throughput is deterministic: albedo / p with
    # p = max(albedo) (the roulette renorm); only survival is random.
    p = albedo.amax(dim=-1)
    thr = albedo / torch.where(p > 0.0, p, 1.0)[:, None]
    spec = _reflect(dirs_sel if kernel else dirs[sel], normal)
    if group > 1:
        widen = lambda x: None if x is None else x.repeat(
            (group,) + (1,) * (x.dim() - 1))
        point, normal, smooth, thr, p, spec, ids, hit_sel = (
            widen(x) for x in (point, normal, smooth, thr, p, spec, ids, hit_sel))

    acc = torch.zeros((width, 3), dtype=torch.float32, device=origins.device)
    if width and max_bounce > 1:  # else the continuation traces nothing
        lane_sample = torch.arange(group, device=origins.device).repeat_interleave(
            width)
        for s in range(0, spp, group):
            with trace_annotation("rtc.shade"):
                sid = offset + s if group == 1 else lane_sample + (offset + s)
                # Same draw order as a full bounce: 6 for the unit vector, 1
                # for roulette.
                state, new_dir, survive = shade.open_sample(
                    seed, ids, sid, normal, smooth, spec, p, scene)
            light_s, cnt = trace_paths(
                point, new_dir, state, scene, max_bounce - 1, backend=backend,
                active=survive if hit_sel is None else survive & hit_sel,
                throughput0=thr,
            )
            for k in range(group):  # in sample order: the association of group 1
                acc = acc + light_s[k * width:(k + 1) * width]
            count += cnt

    with trace_annotation("rtc.compact"):
        contrib = torch.zeros((r, 3), dtype=torch.float32, device=origins.device)
        contrib = (contrib.index_copy_(0, sel, acc) if kernel
                   else contrib.index_copy(0, sel, acc))
    return (light0 * float(spp) + contrib) / float(spp), count


def trace_debug_bounces(origins, dirs, rng_state, scene: Scene, max_bounce: int,
                        backend: str = "auto") -> torch.Tensor:
    """Bounce-count heatmap (reference ``calcDebugColor``): ``[R, 3]`` in
    [0, 1], ``clip(bounces / max(max_bounce, 1), 0, 1)`` per ray.

    Counterpart of the JAX package's ``trace_debug_bounces``: the hit and
    scatter walk at full width under an ``alive`` mask (dead lanes go to the
    search as dead lanes), with the same RNG draw and direction lerp but NO
    Russian roulette: a path ends only on a miss or at ``max_bounce``. The
    JAX package's fixed-length scan becomes a loop that stops once no lane
    is alive, which changes no value.
    """
    scene = with_perm_resolve(scene)
    r = origins.shape[0]
    pos, d, state = origins, dirs, rng_state
    n_bounce = torch.zeros((r,), dtype=torch.float32, device=origins.device)
    alive = torch.ones((r,), dtype=torch.bool, device=origins.device)
    for _ in range(max_bounce):
        with trace_annotation("rtc.compact"):
            if live_lanes(alive)[0].numel() == 0:  # dead in every vmap element
                break
        with trace_annotation("rtc.bounce"):
            COUNTS["integrator.bounces"] += 1
            hit = resolve_hit(pos, d, nearest_hit(pos, d, scene, backend=backend,
                                                  alive=alive), scene)
            with trace_annotation("rtc.shade"):
                state, unit = rng.next_unit_vector(state)
                diffuse = _normalize(hit.normal + unit)
                specular = _reflect(d, hit.normal)
                smooth = hit.smoothness[:, None]
                new_dir = (1.0 - smooth) * diffuse + smooth * specular

                live_hit = alive & hit.hit
                n_bounce = n_bounce + live_hit.to(torch.float32)
                pos = torch.where(live_hit[:, None], hit.point, pos)
                d = torch.where(live_hit[:, None], new_dir, d)
                alive = live_hit
    shade = torch.clamp(n_bounce / float(max(max_bounce, 1)), 0.0, 1.0)
    return shade[:, None].expand(r, 3)


@torch.no_grad()
def render_debug(scene: Scene, camera, width: int, height: int, max_bounce: int,
                 seed: int = 0, backend: str = "auto") -> torch.Tensor:
    """Full-image bounce heatmap, one sample per pixel: ``[H, W, 3]``, on the
    scene's device (the camera is moved there)."""
    origins, dirs = primary_rays(camera.to(scene.device), width, height)
    ray_ids = torch.arange(width * height, dtype=torch.int64,
                           device=scene.device)
    state = rng.stream_init(seed, ray_ids, 0)
    img = trace_debug_bounces(origins, dirs, state, scene, max_bounce,
                              backend=backend)
    return img.reshape(height, width, 3)
