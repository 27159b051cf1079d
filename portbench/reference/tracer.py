"""The path tracer, restated in plain torch: the benchmark's reference.

Semantics of RayTracingC's ``calcColor``, as the program states them: a ray
takes the closest hit over spheres and triangles (Moller-Trumbore with a
backface cull on the stored normal, ``|det| < 1e-3`` degenerate, hits from
``1e-3`` on; the lowest index wins among equal distances, a sphere beats a
triangle at an equal one). On a hit, emission weighted by the throughput
before the albedo multiply; the ray scatters to ``lerp(normalize(normal +
unit), reflect(dir, normal), smoothness)``; Russian roulette on ``p =
max(throughput)`` ends the path or divides the throughput by ``p``. On a
miss the sky and sun light, and the path ends. One RNG stream per (seed,
ray, sample).

The primary hit is the same for every sample, so a pixel's radiance is
``(light0 * spp + sum_s rest_s) / spp``: the light of the first bounce
(emission, or the sky) once, plus each sample's continuation. The search is
a brute-force scan of every (ray, triangle) pair in blocks of rays; each
bounce traces only the lanes still alive. Everything runs in the dtype of
the scene handed in (float32, or bfloat16 for the control), on any device,
and is differentiable through everything but the search (the winning
primitive is found under ``no_grad``; distance, point, normal and material
are recomputed from it with gradients).
"""

from __future__ import annotations

import torch

from portbench.reference import rng
from portbench.reference.scene import RefScene

EPSILON = 1e-3
MISS_DST = 999999.0
BLOCK_PAIRS = 1 << 24  # (ray, triangle) pairs a search block holds


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def _normalize(v):
    x, y, z = v.unbind(-1)
    return v / torch.clamp_min(torch.sqrt(x * x + y * y + z * z), 1e-12)[:, None]


def _reflect(d, n):
    return d - 2.0 * _dot(d, n)[:, None] * n


def _triangle_dst(o, d, a, ab, ac, n):
    """Moller-Trumbore with the backface cull: ``(dst, valid)``."""
    backface = _dot(d, n) >= 0.0
    h = _cross(d, ac)
    det = _dot(ab, h)
    degenerate = det.abs() < EPSILON
    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    s = o - a
    u = _dot(s, h) * inv_det
    q = _cross(s, ab)
    v = _dot(d, q) * inv_det
    dst = _dot(ac, q) * inv_det
    valid = (~backface & ~degenerate & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (dst >= EPSILON))
    return dst, valid


def _sphere_dst(o, d, center, radius):
    offset = o - center
    b = _dot(offset, d)
    delta = b * b - (_dot(offset, offset) - radius * radius)
    miss = delta < 0.0
    sq = torch.sqrt(torch.where(miss, 0.0, delta))
    near, far = -b - sq, -b + sq
    dst = torch.where(near < EPSILON, far, near)
    return dst, ~miss & (dst >= EPSILON) & (radius > 0.0)


@torch.no_grad()
def search(o, d, sc: RefScene, block_pairs: int = BLOCK_PAIRS):
    """Closest hit of every ray: ``(hit, is_tri, idx)``."""
    r, t = o.shape[0], sc.a.shape[0]
    a, ab, ac, n = sc.a, sc.b - sc.a, sc.c - sc.a, sc.normal
    tri_dst = torch.full((r,), MISS_DST, dtype=o.dtype, device=o.device)
    tri_idx = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    step = max(1, block_pairs // max(t, 1))
    for lo in range(0, r if t else 0, step):
        oo, dd = o[lo:lo + step, None, :], d[lo:lo + step, None, :]
        dst, valid = _triangle_dst(oo, dd, a[None], ab[None], ac[None], n[None])
        dmin, idx = torch.where(valid, dst, MISS_DST).min(dim=1)  # first minimum
        tri_dst[lo:lo + step] = dmin
        tri_idx[lo:lo + step] = idx
    tri_idx = torch.where(tri_dst < MISS_DST, tri_idx, -1)
    dst, valid = _sphere_dst(o[:, None, :], d[:, None, :], sc.center[None], sc.radius[None])
    sph_dst, sph_idx = torch.where(valid, dst, MISS_DST).min(dim=1)
    is_tri = tri_dst < sph_dst
    hit = torch.where(is_tri, tri_dst, sph_dst) < MISS_DST
    return hit, is_tri, torch.where(hit, torch.where(is_tri, tri_idx, sph_idx), -1)


def resolve(o, d, ref, sc: RefScene):
    """The winner's ``(point, normal, albedo, emission, smoothness)``, each
    zero on a miss but the point (``o + d * MISS_DST``)."""
    hit, is_tri, idx = ref
    tri_sel, sph_sel = hit & is_tri, hit & ~is_tri
    ti = torch.where(tri_sel, idx, 0)
    si = torch.where(sph_sel, idx, 0)
    a, b, c = sc.a[ti], sc.b[ti], sc.c[ti]
    ab, ac = b - a, c - a
    det = _dot(ab, _cross(d, ac))
    inv_det = 1.0 / torch.where(det.abs() < EPSILON, 1.0, det)
    tri_dst = _dot(ac, _cross(o - a, ab)) * inv_det

    center, radius = sc.center[si], sc.radius[si]
    safe_radius = torch.where(radius > 0.0, radius, 1.0)
    offset = o - center
    bq = _dot(offset, d)
    delta = bq * bq - (_dot(offset, offset) - safe_radius * safe_radius)
    sq = torch.sqrt(torch.clamp_min(delta, 1e-20))
    sph_dst = torch.where(-bq - sq < EPSILON, -bq + sq, -bq - sq)

    dst = torch.where(tri_sel, tri_dst, torch.where(sph_sel, sph_dst, MISS_DST))
    point = o + d * dst[:, None]
    normal = torch.where(tri_sel[:, None], sc.normal[ti],
                         (point - center) / safe_radius[:, None])
    albedo = torch.where(tri_sel[:, None], sc.albedo[ti], sc.s_albedo[si])
    emission = torch.where(tri_sel, sc.emission[ti], sc.s_emission[si])
    smooth = torch.where(tri_sel, sc.smoothness[ti], sc.s_smoothness[si])
    return (point, torch.where(hit[:, None], normal, 0.0),
            torch.where(hit[:, None], albedo, 0.0), torch.where(hit, emission, 0.0),
            torch.where(hit, smooth, 0.0))


def _smoothstep(lo, hi, x):
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _safe_pow(x, p):
    pos = x > 0
    return torch.where(pos, rng.lanewise(lambda t: t.pow(p), torch.where(pos, x, 1.0)), 0.0)


def sky(d, env: dict):
    """Sky, ground and sun light seen along ``d`` (y-down world)."""
    up = -d[..., 1]
    sky_t = _safe_pow(_smoothstep(0.0, 0.74, up), 0.35)[..., None]
    s = (1.0 - sky_t) * env["sky_horizon"] + sky_t * env["sky_zenith"]
    sd = env["sun_direction"]
    cos_sun = torch.clamp_min(d[..., 0] * sd[0] + d[..., 1] * sd[1] + d[..., 2] * sd[2], 0.0)
    sun = _safe_pow(cos_sun, env["sun_focus"]) * env["sun_intensity"]
    sun = torch.where(d[..., 1] < 0, sun, 0.0)
    ground_t = _smoothstep(-0.01, 0.0, up)[..., None]
    return (1.0 - ground_t) * env["ground"] + ground_t * s + sun[..., None]


def _continue(pos, d, state, thr, alive, sc: RefScene, bounces: int, block_pairs):
    """Trace the lanes in ``alive`` for up to ``bounces`` more bounces from
    throughput ``thr``: ``(light [R, 3], rays traced)``."""
    dtype = pos.dtype
    light_out = torch.zeros_like(pos)
    lanes = torch.nonzero(alive).squeeze(1)
    pos, d, state, thr = pos[lanes], d[lanes], state[lanes], thr[lanes]
    light = torch.zeros_like(pos)
    count = 0
    for _ in range(bounces):
        n = lanes.numel()
        if n == 0:
            break
        count += n
        ref = search(pos, d, sc, block_pairs)
        point, normal, albedo, emission, smooth = resolve(pos, d, ref, sc)
        hit = ref[0]
        state, unit = rng.next_unit_vector(state, dtype)
        new_dir = ((1.0 - smooth[:, None]) * _normalize(normal + unit)
                   + smooth[:, None] * _reflect(d, normal))
        light = light + torch.where(hit[:, None], albedo * emission[:, None] * thr, 0.0)
        new_thr = thr * albedo
        state, u = rng.next_uniform(state, dtype)
        p = new_thr.amax(dim=-1)
        survive = p >= u
        new_thr = new_thr / torch.where(p > 0.0, p, 1.0)[:, None]
        light = light + torch.where(~hit[:, None], sky(d, sc.env) * thr, 0.0)
        thr = torch.where(hit[:, None], new_thr, thr)
        pos = torch.where(hit[:, None], point, pos)
        d = torch.where(hit[:, None], new_dir, d)
        keep = torch.nonzero(hit & survive).squeeze(1)
        if keep.numel() < n:
            light_out = light_out.index_copy(0, lanes, light)
            lanes, pos, d, state, thr, light = (
                x[keep] for x in (lanes, pos, d, state, thr, light))
    return light_out.index_copy(0, lanes, light), count


def radiance(origins, dirs, ray_ids, sc: RefScene, seed: int, spp: int,
             max_bounce: int, sample_offset: int = 0,
             block_pairs: int = BLOCK_PAIRS):
    """Mean radiance of ``spp`` samples of every ray: ``(radiance [R, 3],
    rays traced)``, one ray counted per live lane per bounce."""
    dtype = sc.a.dtype
    origins, dirs = origins.to(dtype), dirs.to(dtype)
    r = origins.shape[0]
    if max_bounce < 1:
        return torch.zeros_like(origins), 0
    ref = search(origins, dirs, sc, block_pairs)
    point, normal, albedo, emission, smooth = resolve(origins, dirs, ref, sc)
    hit = ref[0]
    light0 = (torch.where(hit[:, None], albedo * emission[:, None], 0.0)
              + torch.where(~hit[:, None], sky(dirs, sc.env), 0.0))
    count = r * spp
    sel = torch.nonzero(hit).squeeze(1)
    point, normal, albedo = point[sel], normal[sel], albedo[sel]
    smooth, ids = smooth[sel][:, None], ray_ids[sel]
    p = albedo.amax(dim=-1)
    thr = albedo / torch.where(p > 0.0, p, 1.0)[:, None]
    spec = _reflect(dirs[sel], normal)
    acc = torch.zeros_like(point)
    if sel.numel() and max_bounce > 1:
        for s in range(spp):
            state = rng.stream_init(seed, ids, sample_offset + s)
            state, unit = rng.next_unit_vector(state, dtype)
            new_dir = (1.0 - smooth) * _normalize(normal + unit) + smooth * spec
            state, u = rng.next_uniform(state, dtype)
            light, cnt = _continue(point, new_dir, state, thr, p >= u, sc,
                                   max_bounce - 1, block_pairs)
            acc = acc + light
            count += cnt
    contrib = torch.zeros_like(light0).index_copy(0, sel, acc)
    return (light0 * float(spp) + contrib) / float(spp), count


def fit_steps(sc: RefScene, trained: list[str], origins, dirs, ray_ids, target,
              seed: int, spp: int, max_bounce: int, lr: float, steps: int,
              block_pairs: int = BLOCK_PAIRS, render=None):
    """``steps`` steps of Adam on the L2 loss ``sum((radiance - target)^2)
    / (3 R)`` over the scene fields named in ``trained``: ``(losses,
    gradients of the first step, fields after the last step)``. ``render``
    stands in for :func:`radiance` (a planted fault, for the checks' own
    tests)."""
    render = render or radiance
    params = {k: getattr(sc, k).detach().clone().requires_grad_(True) for k in trained}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    tgt = target.reshape(-1, 3).to(sc.a.dtype)
    losses, first = [], None
    for _ in range(steps):
        rad, _ = render(origins, dirs, ray_ids, sc.replace(**params), seed, spp,
                        max_bounce, block_pairs=block_pairs)
        loss = ((rad - tgt) ** 2).sum() / (3 * origins.shape[0])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if first is None:
            first = {k: t.grad.detach().clone() for k, t in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return losses, first, {k: t.detach() for k, t in params.items()}
