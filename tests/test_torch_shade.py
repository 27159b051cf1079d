"""The resolve and shading kernel's plain versions and its route
(``raytracingc_tpu_torch/ops/shade.py``), on the CPU.

Each entry's plain version (the torch composition beside the wrapper)
equals the integrator's composition as it stood before the kernel (copied
below: the bounce step, the hit-front's bounce-0 radiance and its opening
scatter) bit for bit, on lanes that reach every branch: live and dead, hits
on triangles, on the sphere and on the ceiling's emitter, misses that see
the sun, the sky and the ground, smoothness 0, 0.5 and 1, and a scene
resolved through the Morton-permuted table. The route is the kernel's only
on a card with no derivative to see: here every call counts its lanes in
``shade.torch_lanes``; with the card's test stubbed, every production call
counts in ``shade.kernel_lanes``, runs the wrapper (the plain version on a
CPU tensor) and gives the same image, while a gradient, a ``jvp`` and a
``vmap`` keep the torch route, and a block-sharded scene resolves in torch
and steps on the kernel. The kernel itself runs on the card only
(``chip_smoke.py``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raytracingc_tpu_torch import rng
from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.ops import shade
from raytracingc_tpu_torch.ops.env_light import environment_light
from raytracingc_tpu_torch.ops.intersect import Hit, nearest_hit, resolve_hit, with_perm_resolve
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.scene.types import ShardSpec, scene_leaves, with_leaves
from raytracingc_tpu_torch.utils.profiling import COUNTS, counters

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
R = 1024  # lanes of each case
ALIVE = ("none", "masked", "dead")
SMOOTH = (None, 0.0, 0.5, 1.0)  # None: the scene's own (0, 0.05, 0.3)
SCENES = ("box", "no_sphere", "perm")
MODES = {
    "production": {},
    "fast_forward": dict(early_exit=False),
    "sample_group": dict(sample_group=2),
    "sample_batch": dict(sample_batch=2),
    "oracle": dict(early_exit=False, compact=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.detach().contiguous().view(torch.int32) if t.is_floating_point() else t


def _same(a, b):
    """Tuples of tensors (or Hits) equal bit for bit."""
    if isinstance(a, Hit):
        a, b = ([getattr(h, f.name) for f in dataclasses.fields(Hit)] for h in (a, b))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


# --- The integrator's composition before the kernel, as it was. ------------


def _old_normalize(v):
    x, y, z = v.unbind(-1)
    norm = torch.sqrt(x * x + y * y + z * z)
    return v / torch.clamp_min(norm, 1e-12)[:, None]


def _old_reflect(d, n):
    dn = d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1] + d[:, 2] * n[:, 2]
    return d - 2.0 * dn[:, None] * n


def _old_step(pos, d, thr, light, state, hit, alive, scene):
    state, unit = rng.next_unit_vector(state)
    diffuse = _old_normalize(hit.normal + unit)
    specular = _old_reflect(d, hit.normal)
    smooth = hit.smoothness[:, None]
    new_dir = (1.0 - smooth) * diffuse + smooth * specular
    live_hit = hit.hit if alive is None else alive & hit.hit
    live_miss = ~live_hit if alive is None else alive & ~hit.hit
    hm = live_hit[:, None]
    emitted = hit.albedo * hit.emission[:, None]
    light = light + torch.where(hm, emitted * thr, 0.0)
    new_thr = thr * hit.albedo
    state, u_rr = rng.next_uniform(state)
    p = new_thr.amax(dim=-1)
    survive = p >= u_rr
    new_thr = new_thr / torch.where(p > 0.0, p, 1.0)[:, None]
    env = environment_light(d, scene.env)
    light = light + torch.where(live_miss[:, None], env * thr, 0.0)
    thr = torch.where(hm, new_thr, thr)
    pos = torch.where(hm, hit.point, pos)
    d = torch.where(hm, new_dir, d)
    return pos, d, thr, light, state, live_hit & survive


def _old_light0(dirs, hit0, act, scene):
    hitm = hit0.hit & act
    emitted = hit0.albedo * hit0.emission[:, None]
    env = environment_light(dirs, scene.env)
    return (torch.where(hitm[:, None], emitted, 0.0)
            + torch.where((act & ~hit0.hit)[:, None], env, 0.0))


def _old_open(seed, ids, sid, normal, smooth, spec, p):
    state = rng.stream_init(seed, ids, sid)
    state, unit = rng.next_unit_vector(state)
    diffuse = _old_normalize(normal + unit)
    new_dir = (1.0 - smooth) * diffuse + smooth * spec
    state, u_rr = rng.next_uniform(state)
    return state, new_dir, p >= u_rr


# --- Inputs. -----------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes():
    box = tb.scene_from_triangles_txt(BOX_SCENE)
    no_sphere = tb.scene_from_triangles_txt(BOX_SCENE, include_default_spheres=False)
    tt, n = tb.tessellate(box.triangles, box.n_triangles, levels=4)
    x4 = dataclasses.replace(box, triangles=tt, n_triangles=n, accel=None).with_accel()
    os.environ["RTC_RESOLVE"] = "perm"
    try:
        perm = with_perm_resolve(x4)
    finally:
        del os.environ["RTC_RESOLVE"]
    assert perm.resolve_perm is not None and box.n_spheres == 1
    return {"box": box, "no_sphere": no_sphere, "perm": perm}


def _smoothed(scene, smooth):
    if smooth is None:
        return scene
    out = with_leaves(scene, {
        ".triangles.smoothness": torch.full_like(scene.triangles.smoothness, smooth),
        ".spheres.smoothness": torch.full_like(scene.spheres.smoothness, smooth)})
    if scene.resolve_perm is not None:  # the table carries its own copy
        rows = scene.resolve_perm.clone()
        rows[:, 16] = smooth
        out = dataclasses.replace(out, resolve_perm=rows)
    return out


def _lanes(seed=7, n=R):
    """Rays from inside the open-fronted room (hits on every wall, the
    emitter and the sphere; misses through the open front and top) and from
    outside it; positive throughputs and lights; states in [0, 2**32)."""
    g = np.random.default_rng(seed)
    inside = g.uniform([-5, -5, -5], [5, 1.5, 5], (n // 2, 3))
    outside = g.uniform([-30, -30, -30], [30, 30, -10], (n - n // 2, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    return dict(
        pos=f32(np.concatenate([inside, outside])), d=f32(d),
        thr=f32(g.uniform(0.05, 2.0, (n, 3))), light=f32(g.uniform(0.0, 3.0, (n, 3))),
        state=torch.from_numpy(g.integers(0, 2**32, n, dtype=np.int64)))


def _alive(kind, n=R, seed=11):
    if kind == "none":
        return None
    if kind == "dead":
        return torch.zeros(n, dtype=torch.bool)
    return torch.from_numpy(np.random.default_rng(seed).random(n) >= 0.3)


def _covers_every_branch(x, hit, scene):
    """The lanes reach emissive hits, sphere hits, and misses that see the
    sun, the sky above the horizon and the ground."""
    sd = scene.env.sun_direction
    up = x["d"][:, 1] < 0
    sun = (x["d"] @ sd) > 0
    miss = ~hit.hit
    assert (hit.hit & (hit.emission > 0)).any()
    assert (miss & up & sun).any() and (miss & ~up).any()
    if scene.n_spheres:
        assert (hit.hit & (hit.albedo == 1.0).all(dim=1)).any()  # the white sphere


# --- Plain versions == the old composition. -----------------------------------


@pytest.mark.parametrize("scene_name", SCENES)
@pytest.mark.parametrize("alive_kind", ALIVE)
@pytest.mark.parametrize("smooth", SMOOTH)
def test_bounce_plain_is_the_old_step_of_resolve(scenes, scene_name, alive_kind, smooth):
    scene = _smoothed(scenes[scene_name], smooth)
    x, alive = _lanes(), _alive(alive_kind)
    ref = nearest_hit(x["pos"], x["d"], scene, alive=alive)
    hit = resolve_hit(x["pos"], x["d"], ref, scene)
    if alive_kind == "none":
        _covers_every_branch(x, hit, scene)
    args = (x["pos"], x["d"], x["thr"], x["light"], x["state"])
    want = _old_step(*args, hit, alive, scene)
    _same(shade.bounce_plain(*args, ref, alive, scene), want)
    _same(shade.shade_kernel("bounce", *args, ref, alive, scene), want)
    _same(shade.bounce(*args, ref, alive, scene), want)
    if alive_kind == "dead":  # nothing moves, nothing lives; the streams advance
        _same(want[:4], (x["pos"], x["d"], x["thr"], x["light"] + 0.0 + 0.0))
        assert not want[5].any() and not torch.equal(want[4], x["state"])


@pytest.mark.parametrize("scene_name", SCENES)
@pytest.mark.parametrize("alive_kind", ALIVE)
def test_step_plain_is_the_old_step(scenes, scene_name, alive_kind):
    scene = scenes[scene_name]
    x, alive = _lanes(seed=8), _alive(alive_kind, seed=12)
    hit = resolve_hit(x["pos"], x["d"], nearest_hit(x["pos"], x["d"], scene), scene)
    args = (x["pos"], x["d"], x["thr"], x["light"], x["state"], hit, alive, scene)
    want = _old_step(*args)
    _same(shade.step_plain(*args), want)
    _same(shade.shade_kernel("step", *args), want)
    _same(shade.step(*args), want)


@pytest.mark.parametrize("scene_name", SCENES)
@pytest.mark.parametrize("alive_kind", ("none", "masked", "dead"))
def test_primary_plain_is_the_old_resolve_and_light0(scenes, scene_name, alive_kind,
                                                     monkeypatch):
    scene = scenes[scene_name]
    x = _lanes(seed=9)
    act = _alive(alive_kind, seed=13)
    act = torch.ones(R, dtype=torch.bool) if act is None else act
    ref = nearest_hit(x["pos"], x["d"], scene, alive=act)
    hit = resolve_hit(x["pos"], x["d"], ref, scene)
    want_light0 = _old_light0(x["d"], hit, act, scene)
    for got_hit, got_light0 in (
            shade.primary_plain(x["pos"], x["d"], ref, act, scene),
            shade.shade_kernel("primary", x["pos"], x["d"], ref, act, scene)):
        _same(got_hit, hit)
        _same((got_light0,), (want_light0,))
    # Either route gives light0 where the caller passes the live hit lanes,
    # and None where it does not.
    for card in (False, True):
        monkeypatch.setattr(shade, "_on_card", lambda t: card)
        got_hit, got_light0 = shade.primary(x["pos"], x["d"], ref, act, scene,
                                            ref.hit & act)
        _same(got_hit, hit)
        _same((got_light0,), (want_light0,))
        got_hit, none = shade.primary(x["pos"], x["d"], ref, act, scene)
        _same(got_hit, hit)
        assert none is None


@pytest.mark.parametrize("group", (1, 2))
@pytest.mark.parametrize("smooth", (0.0, 0.5, 1.0))
def test_open_plain_is_the_old_opening_scatter(scenes, group, smooth):
    scene = scenes["box"]
    x = _lanes(seed=10, n=R // 2)
    hit = resolve_hit(x["pos"], x["d"], nearest_hit(x["pos"], x["d"], scene), scene)
    sel = torch.nonzero(hit.hit).squeeze(1)
    normal = hit.normal[sel]
    spec = _old_reflect(x["d"][sel], normal)
    p = hit.albedo[sel].amax(dim=-1)
    smooth_t = torch.full((sel.numel(), 1), smooth)
    ids = sel * 7 + 2**33  # only the low 32 bits are a ray's id
    widen = lambda t: t.repeat((group,) + (1,) * (t.dim() - 1))
    normal, spec, p, smooth_t, ids = map(widen, (normal, spec, p, smooth_t, ids))
    offset = 2**32 + 5  # wraps to 5
    sid = offset if group == 1 else (
        torch.arange(group).repeat_interleave(sel.numel()) + offset)
    seed = 2**31 + 17
    want = _old_open(seed, ids, sid, normal, smooth_t, spec, p)
    args = (seed, ids, sid, normal, smooth_t, spec, p, scene)
    _same(shade.open_plain(*args), want)
    _same(shade.shade_kernel("open", *args), want)
    _same(shade.open_sample(*args), want)
    assert want[2].any() and not want[2].all()


# --- The route. ----------------------------------------------------------------


def _render(scene, cam=None, **kw):
    return render(scene, cam or Camera.look_at(), 12, 10, spp=2, max_bounce=4,
                  seed=3, pixel_chunk=64, **kw)


def _lane_counts(fn):
    before = dict(COUNTS)
    out = fn()
    return out, {k: COUNTS[k] - before[k] for k in ("shade.kernel_lanes",
                                                    "shade.torch_lanes")}


@pytest.fixture
def on_card(monkeypatch):
    """The route's device test answers "a card" for CPU tensors: the
    kernel route then runs the wrapper, whose CPU branch is the plain
    version."""
    monkeypatch.setattr(shade, "_on_card", lambda t: True)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_cpu_call_takes_the_torch_route(scenes, mode):
    launches = shade.shade_kernel.launches
    _, lanes = _lane_counts(lambda: _render(scenes["box"], **MODES[mode]))
    assert lanes["shade.kernel_lanes"] == 0 and lanes["shade.torch_lanes"] > 0
    assert shade.shade_kernel.launches == launches


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kernel_route_takes_every_lane_and_keeps_the_bits(scenes, mode, monkeypatch):
    scene = scenes["box"]
    (img, n), torch_lanes = _lane_counts(lambda: _render(scene, **MODES[mode]))
    monkeypatch.setattr(shade, "_on_card", lambda t: True)
    (got, m), lanes = _lane_counts(lambda: _render(scene, **MODES[mode]))
    assert lanes["shade.torch_lanes"] == 0
    assert lanes["shade.kernel_lanes"] == torch_lanes["shade.torch_lanes"] > 0
    assert torch.equal(_bits(got), _bits(img)) and m == n


def test_kernel_route_through_the_permuted_table(scenes, on_card):
    (_, n), lanes = _lane_counts(lambda: _render(scenes["perm"]))
    assert n > 0 and lanes["shade.torch_lanes"] == 0 and lanes["shade.kernel_lanes"] > 0


def test_a_gradient_takes_the_torch_route(scenes, on_card):
    scene = scenes["box"]
    albedo = scene.triangles.albedo.clone().requires_grad_(True)
    s = with_leaves(scene, {".triangles.albedo": albedo})
    (img, _), lanes = _lane_counts(lambda: _render(s, early_exit=False))
    assert lanes["shade.kernel_lanes"] == 0 and lanes["shade.torch_lanes"] > 0
    img.sum().backward()
    assert albedo.grad is not None and albedo.grad.abs().sum() > 0
    # The same render with nothing requiring grad: the kernel route, the same
    # values.
    (plain, _), lanes = _lane_counts(lambda: _render(scene, early_exit=False))
    assert lanes["shade.torch_lanes"] == 0
    assert torch.equal(_bits(plain), _bits(img))


def test_jvp_and_forward_ad_take_the_torch_route(scenes, on_card):
    scene = scenes["box"]
    leaves = {".triangles.albedo": scene.triangles.albedo}
    tangents = {k: torch.ones_like(v) for k, v in leaves.items()}
    f = lambda lv: _render(with_leaves(scene, lv))[0]
    (primal, tangent), lanes = _lane_counts(
        lambda: torch.func.jvp(f, (leaves,), (tangents,)))
    assert lanes["shade.kernel_lanes"] == 0 and lanes["shade.torch_lanes"] > 0
    assert tangent.abs().sum() > 0
    with torch.autograd.forward_ad.dual_level():
        dual = torch.autograd.forward_ad.make_dual(leaves[".triangles.albedo"],
                                                   tangents[".triangles.albedo"])
        _, lanes = _lane_counts(lambda: f({".triangles.albedo": dual}))
    assert lanes["shade.kernel_lanes"] == 0 and lanes["shade.torch_lanes"] > 0
    img, _ = _render(scene)
    assert torch.equal(_bits(primal), _bits(img))


def test_vmap_takes_the_torch_route(scenes, on_card):
    scene = scenes["box"]
    albedo = scene.triangles.albedo
    tables = torch.stack([albedo, albedo * 0.5])
    f = lambda a: _render(with_leaves(scene, {".triangles.albedo": a}))[0]
    imgs, lanes = _lane_counts(lambda: torch.func.vmap(f)(tables))
    assert lanes["shade.kernel_lanes"] == 0 and lanes["shade.torch_lanes"] > 0
    assert torch.equal(_bits(imgs[1]), _bits(f(tables[1])))


def test_block_sharded_scene_takes_the_torch_route(scenes, on_card):
    """A block-sharded scene's resolve (its rows summed across ranks) takes
    the torch route; the step after it takes the kernel."""
    scene = scenes["box"]
    x = _lanes(seed=21)
    ref = nearest_hit(x["pos"], x["d"], scene)
    act = torch.ones(R, dtype=torch.bool)
    sharded = dataclasses.replace(scene, shard=ShardSpec(group=None, rank=0, size=1))
    assert shade.kernel_route(sharded, x["pos"])
    # The sharded resolve's all-reduce needs a process group; here its rows
    # are the replicated scene's, which is what a one-rank group sums to.
    unshard = lambda o, d, r, s: resolve_hit(o, d, r, dataclasses.replace(s, shard=None))
    calls = []
    real_kernel = shade.shade_kernel

    def kernel(entry, *args):
        calls.append(entry)
        return real_kernel(entry, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shade, "resolve_hit", unshard)
        mp.setattr(shade, "shade_kernel", kernel)
        (hit, light0), lanes = _lane_counts(
            lambda: shade.primary(x["pos"], x["d"], ref, act, sharded, ref.hit & act))
        assert calls == [] and lanes["shade.torch_lanes"] == R
        _same(hit, resolve_hit(x["pos"], x["d"], ref, scene))
        _same((light0,), (_old_light0(x["d"], hit, act, scene),))
        walk = (x["pos"], x["d"], x["thr"], x["light"], x["state"])
        got, lanes = _lane_counts(lambda: shade.bounce(*walk, ref, None, sharded))
        assert calls == ["step"] and lanes["shade.kernel_lanes"] == R
    _same(got, _old_step(*walk, resolve_hit(x["pos"], x["d"], ref, scene), None, scene))


def test_route_reads_inputs_and_scene_leaves(scenes, on_card):
    scene = scenes["box"]
    x = _lanes()
    pos = x["pos"].clone().requires_grad_(True)
    assert not shade.kernel_route(scene, pos)
    with torch.no_grad():
        assert shade.kernel_route(scene, pos)
    for name, leaf in scene_leaves(scene).items():
        s = with_leaves(scene, {name: leaf.clone().requires_grad_(True)})
        assert not shade.kernel_route(s, x["pos"]), name


# --- The wrapper and the counters. ---------------------------------------------


def test_counters_report_the_wrapper_and_the_lanes(monkeypatch):
    monkeypatch.setattr(shade.shade_kernel, "launches", 1234)
    snap = counters()
    assert snap["launches.shade_kernel"] == 1234
    assert {"shade.kernel_lanes", "shade.torch_lanes"} <= set(snap)


def test_wrapper_refuses_other_devices(scenes):
    x = {k: v.to("meta") for k, v in _lanes(n=4).items()}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        shade.shade_kernel("bounce", x["pos"], x["d"], x["thr"], x["light"],
                           x["state"], None, None, scenes["box"])


@pytest.mark.parametrize("fault", ("dtype", "shape", "contiguity", "device"))
def test_lane_checks_raise(fault):
    x = torch.zeros((8, 3))
    bad = {"dtype": x.double(), "shape": x[:, :2].contiguous(),
           "contiguity": torch.zeros((3, 8)).t(), "device": x.to("meta")}[fault]
    with pytest.raises(ValueError, match="shade_kernel: pos"):
        shade._lanes("pos", bad, torch.float32, 3, 8, torch.device("cpu"))
    assert shade._lanes("pos", x, torch.float32, 3, 8, torch.device("cpu")) == x.data_ptr()
    assert shade._lanes("alive", None, torch.bool, 0, 8, torch.device("cpu")) is None


@pytest.mark.parametrize("scene_name", SCENES)
def test_leaf_tensors_are_the_scene_leaves(scenes, scene_name):
    scene = scenes[scene_name]
    got, want = shade._leaf_tensors(scene), tuple(scene_leaves(scene).values())
    assert len(got) == len(want) and all(a is b for a, b in zip(got, want))


def test_scene_tables_in_the_entries_order(scenes):
    box, perm = scenes["box"], scenes["perm"]
    tables, _, copies = shade._scene_args(box, box.device)
    assert copies == []  # the loader's tables are contiguous
    box = _strided(box)
    tables, rows, copies = shade._scene_args(box, box.device)
    assert rows == box.triangles.count and len(tables) == 20
    # The tables that were not contiguous are copied for the call.
    assert copies and all(x.is_contiguous() for x in copies)
    assert torch.equal(copies[0], box.triangles.a) and tables[0] == copies[0].data_ptr()
    assert tables[0] != box.triangles.a.data_ptr()
    assert tables[4] == box.triangles.albedo.data_ptr()
    assert tables[7] is None and tables[8] is None
    assert tables[19] == box.env.sun_intensity.data_ptr()
    tables, _, _ = shade._scene_args(perm, perm.device)
    assert tables[7] == perm.resolve_perm.data_ptr()
    assert tables[8] == perm.accel.perm_of_orig.data_ptr()
    bad = with_leaves(box, {".spheres.radius": box.spheres.radius.double()})
    with pytest.raises(ValueError, match="spheres.radius"):
        shade._scene_args(bad, box.device)


def _fresh(scene):
    """``scene`` with contiguous copies of its leaves."""
    return with_leaves(scene, {k: v.clone(memory_format=torch.contiguous_format)
                               for k, v in scene_leaves(scene).items()})


def _strided(scene):
    """``scene`` with its vertices as columns of one ``[T, 9]`` array."""
    t = scene.triangles
    rows = torch.cat([t.a, t.b, t.c], dim=1)
    return with_leaves(scene, {".triangles.a": rows[:, 0:3], ".triangles.b": rows[:, 3:6],
                               ".triangles.c": rows[:, 6:9]})


def test_scene_tables_reused_for_the_same_scene_only(scenes):
    box = _fresh(scenes["box"])
    first = shade._scene_args(box, box.device)
    assert first[2] == [] and all(p == x.data_ptr() for p, x in zip(
        (*first[0][:7], *first[0][9:]), shade._leaf_tensors(box)))
    again = shade._scene_args(box, box.device)
    assert again[0] is first[0] and again[2] == ()
    albedo = box.triangles.albedo * 0.5
    other = with_leaves(box, {".triangles.albedo": albedo})
    tables, _, _ = shade._scene_args(other, other.device)
    assert tables[4] == albedo.data_ptr() != first[0][4]
    again = shade._scene_args(box, box.device)  # recomputed: the same pointers
    assert again[0] is not first[0] and list(again[0]) == list(first[0])
    # A scene that needed copies is not kept, and the cache holds no tensor:
    # the scene's tables are freed with it.
    loose = _strided(scenes["box"])
    assert shade._scene_args(loose, loose.device)[0] is not shade._scene_args(
        loose, loose.device)[0]
    import gc
    import weakref
    gone = _fresh(scenes["box"])
    shade._scene_args(gone, gone.device)
    table = weakref.ref(gone.triangles.a)
    del gone
    gc.collect()
    assert table() is None and shade._last_scene[0]() is None
