"""Resolve, shading and RNG of a bounce: the CUDA kernel, its plain versions
and the route between them.

The integrator's per-lane arithmetic (``ops/intersect.py`` :func:`resolve_hit`,
the bounce step, ``ops/env_light.py``, ``rng.py``) is ~300 eager torch
launches a bounce. ``csrc/shade.cu`` runs it in one launch per call, for the
four calls of the integrator (one entry each):

* :func:`bounce`: the loop's bounce, the search's winner resolved and the
  step taken (:func:`bounce_plain`: :func:`step_plain` of :func:`resolve_hit`);
* :func:`primary`: a chunk's primary resolve, with the hit-front's bounce-0
  radiance ``light0`` where the caller asks for it (:func:`primary_plain`);
* :func:`open_sample`: the opening scatter of a continuation sample
  (:func:`open_plain`: ``stream_init``, the unit vector, the direction lerp,
  the roulette draw);
* :func:`step`: the step on a hit already resolved (:func:`step_plain`).

**The route**, by what the input shows: the kernel when the tensors are on a
card, no derivative can be seen (``ops/no_tangent.py`` ``_plain_call``: no
functorch transform, no forward-AD level, no input or scene leaf requiring
grad while grad mode is on). A block-sharded scene's resolve stays in torch,
since it sums the winners' rows across ranks: its bounce is
:func:`resolve_hit` then the step entry, its primary resolve and ``light0``
are torch. Otherwise the plain version runs: the torch
composition as it was, op for op, which autograd, ``jvp``, ``jacfwd`` and
``vmap`` differentiate through. The kernel gives the plain version's bits
(``csrc/shade.cu``'s note says how); ``chip_smoke.py`` holds it so.

:func:`shade_kernel` is the kernel's wrapper: a CUDA tensor launches the
entry (counted in ``shade_kernel.launches``) or raises on a wrong device,
dtype, shape or contiguity; a CPU tensor runs the plain version. No input is
written. Counters (``utils/profiling.py``): ``shade.kernel_lanes`` and
``shade.torch_lanes``, the lanes of each call by its route. On the kernel
route the bounce and step launches sit in an ``rtc.shade`` span, the
primary's in ``rtc.resolve``, the opening scatter in its caller's
``rtc.shade``.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from raytracingc_tpu_torch import rng
from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.ops.env_light import environment_light
from raytracingc_tpu_torch.ops.intersect import Hit, HitRef, resolve_hit
from raytracingc_tpu_torch.ops.no_tangent import _plain_call
from raytracingc_tpu_torch.scene.types import LEAF_PATHS, Scene
from raytracingc_tpu_torch.utils.profiling import COUNTS, trace_annotation

# ---------------------------------------------------------------------------
# Plain versions: the torch composition, op for op.


def normalize(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    norm = torch.sqrt(x * x + y * y + z * z)
    return v / torch.clamp_min(norm, 1e-12)[:, None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection."""
    dn = d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1] + d[:, 2] * n[:, 2]
    return d - 2.0 * dn[:, None] * n


def step_plain(pos, d, thr, light, state, hit: Hit, alive, scene: Scene):
    """One bounce on the given hit: scatter, emission, roulette and miss.
    ``alive`` is a bool ``[R]`` mask, or None when every lane is alive.
    Returns the next ``(pos, d, thr, light, state, alive)``."""
    with trace_annotation("rtc.shade"):
        state, unit = rng.next_unit_vector(state)
        diffuse = normalize(hit.normal + unit)
        specular = reflect(d, hit.normal)
        smooth = hit.smoothness[:, None]
        new_dir = (1.0 - smooth) * diffuse + smooth * specular

        # Emission weighted by the PRE-update throughput, then albedo.
        live_hit = hit.hit if alive is None else alive & hit.hit
        live_miss = ~live_hit if alive is None else alive & ~hit.hit
        hm = live_hit[:, None]
        emitted = hit.albedo * hit.emission[:, None]
        light = light + torch.where(hm, emitted * thr, 0.0)
        new_thr = thr * hit.albedo

        # Russian roulette: survive iff p >= u. amax shares its gradient evenly
        # between tied channels, as jnp.max does.
        state, u_rr = rng.next_uniform(state)
        p = new_thr.amax(dim=-1)
        survive = p >= u_rr
        new_thr = new_thr / torch.where(p > 0.0, p, 1.0)[:, None]

        # Miss: add the environment light and end the path.
        env = environment_light(d, scene.env)
        light = light + torch.where(live_miss[:, None], env * thr, 0.0)

        thr = torch.where(hm, new_thr, thr)
        pos = torch.where(hm, hit.point, pos)
        d = torch.where(hm, new_dir, d)
        return pos, d, thr, light, state, live_hit & survive


def bounce_plain(pos, d, thr, light, state, ref: HitRef, alive, scene: Scene):
    """The loop's bounce: :func:`step_plain` on :func:`resolve_hit` of the
    search's winner ``ref``."""
    return step_plain(pos, d, thr, light, state, resolve_hit(pos, d, ref, scene),
                      alive, scene)


def light0_plain(dirs, hit0: Hit, hitm, act, env) -> torch.Tensor:
    """The hit-front's bounce-0 radiance: emission on the live hit lanes
    ``hitm`` (``hit0.hit & act``), the environment light on the live miss
    lanes (throughput 1)."""
    emitted = hit0.albedo * hit0.emission[:, None]
    env = environment_light(dirs, env)
    return (torch.where(hitm[:, None], emitted, 0.0)
            + torch.where((act & ~hit0.hit)[:, None], env, 0.0))


def primary_plain(o, d, ref: HitRef, act, scene: Scene):
    """A chunk's primary resolve: ``(Hit, light0)`` over the lanes ``act``."""
    hit = resolve_hit(o, d, ref, scene)
    return hit, light0_plain(d, hit, hit.hit & act, act, scene.env)


def open_plain(seed: int, ids, sid, normal, smooth, spec, p, scene: Scene):
    """The opening scatter of a continuation sample: each lane's stream
    ``(seed, ids, sid)`` (``sid`` an int or an int64 ``[R]``), the unit
    vector (6 draws), the lerp of the diffuse and the mirror direction
    ``spec`` by ``smooth [R, 1]``, then the roulette draw (1) against ``p``.
    Returns ``(state, new_dir, survive)``."""
    state = rng.stream_init(seed, ids, sid)
    state, unit = rng.next_unit_vector(state)
    diffuse = normalize(normal + unit)
    new_dir = (1.0 - smooth) * diffuse + smooth * spec
    state, u_rr = rng.next_uniform(state)
    return state, new_dir, p >= u_rr


# ---------------------------------------------------------------------------
# The kernel's wrapper.

def _leaf_tensors(scene: Scene) -> tuple:
    """The scene's leaves (``scene_leaves(scene).values()``, in its order)
    without the dict: the route reads them on every call."""
    t, s, e = scene.triangles, scene.spheres, scene.env
    return (t.a, t.b, t.c, t.normal, t.albedo, t.emission, t.smoothness,
            s.center, s.radius, s.albedo, s.emission, s.smoothness,
            e.sun_direction, e.sky_horizon, e.sky_zenith, e.ground, e.sun_focus,
            e.sun_intensity)


# The last scene's table pointers, while that scene object lives, kept only
# where every table was already contiguous (so no copy is held, and the
# pointers are the scene's own tensors'): a render's calls (~500 for a 1080p
# frame) share one scene object, and building the array costs ~35 us of host
# time a call (PERF.md). Scene is frozen; a table changed in place keeps its
# pointer.
_last_scene = (lambda: None, None, None)


def _scene_args(scene: Scene, device):
    """``(host array of the scene's 20 table pointers, triangle rows,
    copies)`` in the C entries' order (``csrc/shade.cu`` scene_tables): each
    table float32 (``perm_of_orig`` int32) of its shape on ``device``, a
    contiguous copy where it was not contiguous (``copies`` holds them for
    the launch); the Morton-permuted pair null unless ``resolve_perm`` is
    attached. The last scene's pointers are reused where it needed no
    copy."""
    global _last_scene
    ref, dev, args = _last_scene
    if ref() is scene and dev == device:
        return (*args, ())
    ptrs, t, copies = _scene_tables(scene, device)
    if not copies:
        _last_scene = (weakref.ref(scene), device, (ptrs, t))
    return ptrs, t, copies


def _scene_tables(scene: Scene, device):
    """:func:`_scene_args` of a scene not seen last."""
    t, s = scene.triangles.count, scene.spheres.count
    perm = scene.resolve_perm
    f32 = torch.float32
    leaves = zip(LEAF_PATHS, _leaf_tensors(scene), (
        (t, 3), (t, 3), (t, 3), (t, 3), (t, 3), (t,), (t,),
        (s, 3), (s,), (s, 3), (s,), (s,), (3,), (3,), (3,), (3,), (), ()))
    tables = [(name[1:], x, f32, shape) for name, x, shape in leaves]
    tables[7:7] = [
        ("resolve_perm", perm, f32, (t, 17)),
        ("accel.perm_of_orig", None if perm is None else scene.accel.perm_of_orig,
         torch.int32, (t,))]
    ptrs, copies = [], []
    for name, x, dtype, shape in tables:
        if x is not None and (x.dtype != dtype or x.device != device
                              or tuple(x.shape) != shape):
            raise ValueError(f"shade_kernel: {name} is {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}; expected {dtype} {shape} on {device}")
        if x is not None and not x.is_contiguous():
            x = x.contiguous()
            copies.append(x)
        ptrs.append(None if x is None else x.data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs), t, copies


def _lanes(name, x, dtype, width, n, device):
    """The pointer of a per-lane input: ``dtype`` ``[n]`` (width 0) or
    ``[n, width]``, contiguous on ``device``; None stays None."""
    if x is None:
        return None
    shape = (n,) if width == 0 else (n, width)
    if x.dtype != dtype or x.shape != shape:
        raise ValueError(f"shade_kernel: {name} is {x.dtype} {tuple(x.shape)}, "
                         f"expected {dtype} {shape}")
    if x.device != device:
        raise ValueError(f"shade_kernel: {name} is on {x.device}, not {device}")
    if not x.is_contiguous():
        raise ValueError(f"shade_kernel: {name} is not contiguous")
    return x.data_ptr()


def _call(entry: str, device, n: int, *args) -> None:
    """Launch ``rtc_shade_<entry>`` over ``n`` lanes on the current stream
    of ``device``; with no lane nothing is launched or counted."""
    if n == 0:
        return
    with _build.card(device) as (lib, stream):
        code = getattr(lib, f"rtc_shade_{entry}")(*args, stream)
    _build.check(code, f"shade_kernel {entry} launch")
    shade_kernel.launches += 1


_F, _B, _I32, _I64 = torch.float32, torch.bool, torch.int32, torch.int64


def _empty(n, device, *specs):
    return [torch.empty((n,) if w == 0 else (n, w), dtype=t, device=device)
            for t, w in specs]


def _launch_walk(entry, pos, d, thr, light, state, hit_args, alive, scene):
    """The bounce and step entries: ``hit_args`` are the search's winner
    (bounce) or the resolved hit's fields (step)."""
    n, dev = pos.shape[0], pos.device
    tables, n_rows, _copies = _scene_args(scene, dev)
    ins = [_lanes(k, x, t, w, n, dev) for k, x, t, w in (
        ("pos", pos, _F, 3), ("d", d, _F, 3), ("thr", thr, _F, 3),
        ("light", light, _F, 3), ("state", state, _I64, 0), *hit_args)]
    outs = _empty(n, dev, (_F, 3), (_F, 3), (_F, 3), (_F, 3), (_I64, 0), (_B, 0))
    _call(entry, dev, n, tables, n_rows, *ins, _lanes("alive", alive, _B, 0, n, dev), n,
          *(x.data_ptr() for x in outs))
    return tuple(outs)


def _launch_bounce(pos, d, thr, light, state, ref: HitRef, alive, scene):
    return _launch_walk("bounce", pos, d, thr, light, state, (
        ("ref.hit", ref.hit, _B, 0), ("ref.is_tri", ref.is_tri, _B, 0),
        ("ref.idx", ref.idx, _I32, 0)), alive, scene)


def _launch_step(pos, d, thr, light, state, hit: Hit, alive, scene):
    return _launch_walk("step", pos, d, thr, light, state, (
        ("hit.hit", hit.hit, _B, 0), ("hit.point", hit.point, _F, 3),
        ("hit.normal", hit.normal, _F, 3), ("hit.albedo", hit.albedo, _F, 3),
        ("hit.emission", hit.emission, _F, 0),
        ("hit.smoothness", hit.smoothness, _F, 0)), alive, scene)


def _launch_primary(o, d, ref: HitRef, act, scene):
    n, dev = o.shape[0], o.device
    tables, n_rows, _copies = _scene_args(scene, dev)
    ins = [_lanes(k, x, t, w, n, dev) for k, x, t, w in (
        ("o", o, _F, 3), ("d", d, _F, 3), ("ref.hit", ref.hit, _B, 0),
        ("ref.is_tri", ref.is_tri, _B, 0), ("ref.idx", ref.idx, _I32, 0),
        ("act", act, _B, 0))]
    dst, point, normal, albedo, emission, smoothness, light0 = _empty(
        n, dev, (_F, 0), (_F, 3), (_F, 3), (_F, 3), (_F, 0), (_F, 0), (_F, 3))
    _call("primary", dev, n, tables, n_rows, *ins, n,
          *(x.data_ptr() for x in (dst, point, normal, albedo, emission, smoothness,
                                   light0)))
    return Hit(hit=ref.hit, dst=dst, point=point, normal=normal, albedo=albedo,
               emission=emission, smoothness=smoothness), light0


def _launch_open(seed, ids, sid, normal, smooth, spec, p, scene):
    n, dev = normal.shape[0], normal.device
    if smooth.shape != (n, 1):
        raise ValueError(f"shade_kernel: smooth is {tuple(smooth.shape)}, "
                         f"expected ({n}, 1)")
    per_lane = isinstance(sid, torch.Tensor)
    ins = [_lanes(k, x, t, w, n, dev) for k, x, t, w in (
        ("ids", ids, _I64, 0), ("sid", sid if per_lane else None, _I64, 0),
        ("normal", normal, _F, 3), ("smooth", smooth.reshape(n), _F, 0),
        ("spec", spec, _F, 3), ("p", p, _F, 0))]
    state, new_dir, survive = _empty(n, dev, (_I64, 0), (_F, 3), (_B, 0))
    s0 = rng._splitmix((int(seed) + rng._SM_GAMMA) & rng._M32)
    sample0 = 0 if per_lane else int(sid) & rng._M32
    _call("open", dev, n, s0, ins[0], ins[1], sample0, *ins[2:], n,
          state.data_ptr(), new_dir.data_ptr(), survive.data_ptr())
    return state, new_dir, survive


_PLAIN = {"bounce": bounce_plain, "step": step_plain, "primary": primary_plain,
          "open": open_plain}
_LAUNCH = {"bounce": _launch_bounce, "step": _launch_step,
           "primary": _launch_primary, "open": _launch_open}


def shade_kernel(entry: str, *args):
    """One call of the kernel's ``entry`` (``"bounce"``, ``"step"``,
    ``"primary"``, ``"open"``) on the arguments of its plain version
    (:func:`bounce_plain`, :func:`step_plain`, :func:`primary_plain`,
    :func:`open_plain`), whose results it returns bit for bit. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel (built on
    first use) and counts the launch in ``shade_kernel.launches``; any other
    device raises."""
    device = args[1].device if entry == "open" else args[0].device
    if device.type == "cpu":
        return _PLAIN[entry](*args)
    if device.type != "cuda":
        raise RuntimeError(f"shade_kernel: no kernel for device {device}")
    return _LAUNCH[entry](*args)


shade_kernel.launches = 0


# ---------------------------------------------------------------------------
# The route, and the integrator's four calls.


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def kernel_route(scene: Scene, *tensors) -> bool:
    """Whether a call on ``tensors`` takes the kernel: they are on a card,
    and no derivative can be seen in them or in the scene's leaves."""
    return _on_card(tensors[0]) and _plain_call((*tensors, *_leaf_tensors(scene)), {})


def _tally(kernel: bool, n: int) -> bool:
    COUNTS["shade.kernel_lanes" if kernel else "shade.torch_lanes"] += n
    return kernel


def bounce(pos, d, thr, light, state, ref: HitRef, alive, scene: Scene):
    """The loop's bounce on the search's winner ``ref``: the next ``(pos,
    d, thr, light, state, alive)``. A block-sharded scene resolves in torch
    (its rows are summed across ranks) and steps on the kernel."""
    if not _tally(kernel_route(scene, pos, d, thr, light), pos.shape[0]):
        return bounce_plain(pos, d, thr, light, state, ref, alive, scene)
    if scene.shard is not None:
        return _step_kernel(pos, d, thr, light, state, resolve_hit(pos, d, ref, scene),
                            alive, scene)
    with trace_annotation("rtc.shade"):
        return shade_kernel("bounce", pos, d, thr, light, state, ref, alive, scene)


def _step_kernel(pos, d, thr, light, state, hit: Hit, alive, scene: Scene):
    with trace_annotation("rtc.shade"):
        return shade_kernel("step", pos, d, thr, light, state, hit, alive, scene)


def step(pos, d, thr, light, state, hit: Hit, alive, scene: Scene):
    """The step on a resolved ``hit``: the next ``(pos, d, thr, light,
    state, alive)``."""
    if not _tally(kernel_route(scene, pos, d, thr, light, hit.point, hit.normal,
                               hit.albedo, hit.emission, hit.smoothness),
                  pos.shape[0]):
        return step_plain(pos, d, thr, light, state, hit, alive, scene)
    return _step_kernel(pos, d, thr, light, state, hit, alive, scene)


def primary(o, d, ref: HitRef, act, scene: Scene, hitm=None):
    """A chunk's primary resolve over the lanes ``act``: ``(Hit, light0)``
    on either route, ``light0`` (:func:`light0_plain`, the hit-front's
    bounce-0 radiance) where the caller passes its live hit lanes ``hitm``
    (``ref.hit & act``), else None. A block-sharded scene resolves in torch
    (its rows are summed across ranks)."""
    if not _tally(kernel_route(scene, o, d) and scene.shard is None, o.shape[0]):
        hit = resolve_hit(o, d, ref, scene)
        if hitm is None:
            return hit, None
        with trace_annotation("rtc.shade"):
            return hit, light0_plain(d, hit, hitm, act, scene.env)
    with trace_annotation("rtc.resolve"):
        hit, light0 = shade_kernel("primary", o, d, ref, act, scene)
    return hit, None if hitm is None else light0


def open_sample(seed: int, ids, sid, normal, smooth, spec, p, scene: Scene):
    """The opening scatter of a continuation sample (:func:`open_plain`):
    ``(state, new_dir, survive)``."""
    if not _tally(kernel_route(scene, normal, smooth, spec, p), normal.shape[0]):
        return open_plain(seed, ids, sid, normal, smooth, spec, p, scene)
    return shade_kernel("open", seed, ids, sid, normal, smooth, spec, p, scene)
