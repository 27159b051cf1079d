"""The culling prelude's kernel (``csrc/cull_words.cu``): its plain version
and its route, on the CPU.

The oracle is the torch composition the word routes ran before the kernel
was their one path, frozen here: ``_box_words`` (the slab tests of
``culling.packets``, 31 boxes to a word) and the route entries built on it.

* ``culling.cull_words_reference``, the kernel's per-lane arithmetic in
  torch, equals the frozen ``_box_words`` bit for bit on rays with a ragged
  tail packet, dead lanes and ``alive=None``, zero, tiny and ``-0.0``
  direction components, origins on box faces and inside boxes, NaN and
  infinities in live lanes, and box lists with inverted, NaN and infinite
  boxes, at 1 to 10 words.
* Each word route's entry (``culling.packet_block_masks``,
  ``packet_tile_words[_multi]``, ``program_union_words``) gives the frozen
  composition's words (and union flags).
* The route (``ops/search.py`` ``_cull``): every word route calls
  ``culling.cull_words`` once a search (on the CPU its plain version, no
  launch) and renders the bits of the frozen composition, the SPD ``tetra``
  scene included; the range route never calls it; ``jvp`` and ``vmap``
  through a K2-route search still work. The wrapper raises on a wrong
  dtype, shape, contiguity or device.

The kernel itself runs on the card only (``chip_smoke.py``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.utils.profiling import COUNTS, counters

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
TETRA = os.path.join(os.path.dirname(__file__), "..", "portbench", "configs",
                     "spd_tetra.txt")
NAN, INF = float("nan"), float("inf")
KNOBS = ("RTC_KERNEL", "RTC_CULL", "RTC_STREAM_CULL", "RTC_STREAM_ORDER",
         "RTC_BRUTE_MAX", "RTC_BITMASK_MAX_WORDS", "RTC_STREAM_MAX_T",
         "RTC_STREAM_TILE", "RTC_STREAM_GRANULE")
# Knobs that pick each route of ops/search.py on box_scene --tessellate 3
# (640 triangles, 5 blocks, one word).
TINY_STREAM = {"RTC_STREAM_MAX_T": "256", "RTC_STREAM_TILE": "256"}
ROUTES = {
    "bitmask K2": {"RTC_KERNEL": "packet"},
    "packed K3 resident": {"RTC_KERNEL": "packet", "RTC_BITMASK_MAX_WORDS": "0"},
    "packed K3 streamed": {"RTC_KERNEL": "packet", **TINY_STREAM},
    "packed K3 granule 2": {"RTC_KERNEL": "packet", "RTC_BITMASK_MAX_WORDS": "0",
                            "RTC_STREAM_GRANULE": "2"},
    "words K6": {"RTC_KERNEL": "packet", "RTC_STREAM_CULL": "words",
                 "RTC_BITMASK_MAX_WORDS": "0"},
    "words K7": {"RTC_KERNEL": "packet", "RTC_STREAM_CULL": "words", **TINY_STREAM},
    "mxu K8": {"RTC_KERNEL": "mxu"},
    "range K4": {"RTC_KERNEL": "packet", "RTC_CULL": "range"},
}


@pytest.fixture(autouse=True)
def _one_thread_clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t



def _boxes(rng, n):
    """``n`` boxes around the rays, with inverted, NaN, flat, infinite and
    huge ones among them."""
    c = rng.uniform(-2.0, 2.0, (n, 3))
    h = rng.uniform(0.05, 0.8, (n, 3))
    lo, hi = (c - h).astype(np.float32), (c + h).astype(np.float32)
    lo[1::17], hi[1::17] = hi[1::17] + 0.1, lo[1::17]  # inverted
    lo[5::23, 1] = NAN
    hi[7::29, 2] = NAN
    hi[3::19] = lo[3::19]  # a point
    lo[9::31, 0], hi[9::31, 0] = -INF, INF  # a slab open along x
    lo[11::37], hi[11::37] = -3.0e38, 3.0e38  # trivial_accel's box
    return torch.from_numpy(lo), torch.from_numpy(hi)


def _rays(rng, r, lo, hi, alive):
    """``(o, d, alive)``: ``r`` rays, most aimed at a box, with special
    values; ``alive`` is None, a mask with packets partly and wholly dead,
    or all dead."""
    n = lo.shape[0]
    o = rng.uniform(-3.0, 3.0, (r, 3)).astype(np.float32)
    lo_n, hi_n = lo.numpy(), hi.numpy()
    with np.errstate(invalid="ignore"):
        mid = (lo_n + hi_n) / 2  # NaN for the open slabs
    target = np.nan_to_num(mid, nan=0.0, posinf=0.0, neginf=0.0)
    target = np.clip(target, -3.0, 3.0)[rng.integers(0, n, r)]
    d = (target - o + rng.normal(0.0, 0.3, (r, 3))).astype(np.float32)
    d[::5, 0] = 0.0
    d[1::7, 1] = -0.0
    d[2::9, 2] = 1e-21
    d[3::11, 0] = -1e-21
    k = rng.integers(0, n, r)
    face = np.where(np.isfinite(lo_n[k]) & (np.abs(lo_n[k]) < 10), lo_n[k], 0.0)
    o[4::13] = face[4::13]  # on a corner of a box (or its faces' planes)
    o[6::13, 1] = np.nan_to_num(hi_n[k[6::13], 1], nan=0.5, posinf=0.5, neginf=0.5)
    o[8::13] = np.nan_to_num(mid[k][8::13], nan=0.0)  # inside
    o[10::37, 0] = NAN
    d[12::41, 1] = NAN
    o[14::43, 2] = INF
    d[16::47, 0] = -INF
    d[18::53] = [INF, 0.0, -INF]
    o[20::59] = [-INF, INF, 0.0]
    live = None
    if alive == "partial":
        live = rng.random(r) > 0.4
        live[-8:] = [False] * 7 + [True]  # a packet of one live lane
        live[:8] = False  # a whole dead packet, and the tail's one live lane
        live[r - 1] = True
    elif alive == "dead":
        live = np.zeros(r, bool)
    return (torch.from_numpy(o), torch.from_numpy(d),
            None if live is None else torch.from_numpy(live[:r]))


# --- The frozen torch composition. -----------------------------------------


def _box_words(lo_w, hi_w, o_p, d_p, a_p):
    """Words of boxes grouped 31 to a word: ``lo_w/hi_w [N, 31, 3]`` →
    ``[C, N]`` int32, bit ``j`` of word ``n`` set iff box ``(n, j)`` passes
    for some live lane. Tested in groups of words to bound memory."""
    inv_p = culling._inv_dir(d_p)
    c, n = o_p.shape[0], lo_w.shape[0]
    bits = torch.ones((), dtype=torch.int32, device=o_p.device) << torch.arange(
        culling.BITS_PER_WORD, dtype=torch.int32, device=o_p.device)
    zero = torch.zeros((), dtype=torch.int32, device=o_p.device)
    per_word = c * culling.RAY_SUBLANES * culling.BITS_PER_WORD * 3
    step = max(1, culling.SLAB_ELEMS_BUDGET // max(per_word, 1))
    out = [torch.zeros((c, 0), dtype=torch.int32, device=o_p.device)]
    for w0 in range(0, n, step):
        lo = lo_w[w0:w0 + step].reshape(-1, 3)
        hi = hi_w[w0:w0 + step].reshape(-1, 3)
        hit = culling.slab_any_hit(lo, hi, o_p, inv_p, a_p).reshape(
            c, lo.shape[0] // culling.BITS_PER_WORD, culling.BITS_PER_WORD)
        out.append(torch.where(hit, bits, zero).sum(dim=2, dtype=torch.int32))
    return torch.cat(out, dim=1)


def _torch_prelude(o, d, alive, lo, hi):
    """The torch prelude on a list of boxes: padded to whole words with
    inverted boxes, then ``_box_words`` of the rays' packets."""
    w = -(-lo.shape[0] // culling.BITS_PER_WORD)
    lo_p, hi_p = culling._pad_boxes(lo, hi, w * culling.BITS_PER_WORD, 0)
    return _box_words(lo_p.reshape(w, culling.BITS_PER_WORD, 3),
                      hi_p.reshape(w, culling.BITS_PER_WORD, 3),
                      *culling.packets(o, d, alive))


def _torch_block_masks(o, d, alive, accel):
    return _torch_prelude(o, d, alive, accel.aabb_lo, accel.aabb_hi)


def _torch_union_words(o, d, alive, accel):
    return culling.program_union(_torch_block_masks(o, d, alive, accel))


def _torch_tile_words_multi(o, d, alive, accel, n_tiles, bpt, granule):
    lo, hi, n_words = culling.tile_boxes(accel, n_tiles, bpt, granule)
    return _box_words(lo.reshape(n_tiles * n_words, culling.BITS_PER_WORD, 3),
                      hi.reshape(n_tiles * n_words, culling.BITS_PER_WORD, 3),
                      *culling.packets(o, d, alive)).reshape(-1, n_tiles, n_words)


def _torch_tile_words(o, d, alive, accel, n_tiles, bpt, granule):
    return _torch_tile_words_multi(o, d, alive, accel, n_tiles, bpt, granule)[..., 0]


# The word routes' entries in ``culling`` and their frozen compositions.
FROZEN = {"packet_block_masks": _torch_block_masks,
          "program_union_words": _torch_union_words,
          "packet_tile_words_multi": _torch_tile_words_multi,
          "packet_tile_words": _torch_tile_words}


# --- The plain version against the torch prelude. ---------------------------


@pytest.mark.parametrize("alive", ("none", "partial", "dead"))
@pytest.mark.parametrize("n_boxes", (1, 31, 40, 128, 155, 248, 250, 300))
@pytest.mark.parametrize("n_rays", (8, 203))
def test_plain_version_is_the_torch_prelude(n_rays, n_boxes, alive):
    rng = np.random.default_rng([n_rays, n_boxes, len(alive)])
    lo, hi = _boxes(rng, n_boxes)
    o, d, live = _rays(rng, n_rays, lo, hi, alive)
    got = culling.cull_words_reference(o, d, live, lo, hi)
    want = _torch_prelude(o, d, live, lo, hi)
    assert got.dtype == torch.int32
    assert got.shape == (-(-n_rays // 8), -(-n_boxes // 31))
    assert torch.equal(got, want)
    assert (got >= 0).all()  # bit 31 is never set
    if alive == "dead":
        assert not got.any()
    elif n_boxes > 1:
        assert got.any()


def test_a_nan_or_an_infinity_in_a_live_lane_follows_torch():
    """A packet whose one live lane carries a NaN or an infinity: its bits
    are the torch prelude's (a NaN slab value misses every box)."""
    lo = torch.tensor([[-1.0, -1.0, -1.0], [0.5, -INF, -1.0], [-3e38, -3e38, -3e38]])
    hi = torch.tensor([[1.0, 1.0, 1.0], [2.0, INF, 1.0], [3e38, 3e38, 3e38]])
    rows = [([0.0, 0.0, -5.0], [0.0, 0.0, 1.0]), ([NAN, 0.0, -5.0], [0.0, 0.0, 1.0]),
            ([0.0, 0.0, -5.0], [0.0, NAN, 1.0]), ([INF, 0.0, 0.0], [1.0, 0.0, 0.0]),
            ([0.0, 0.0, 0.0], [0.0, INF, 0.0]), ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
            ([1.0, 0.0, 0.0], [-0.0, -1e-21, 1e-21]), ([-2.0, 0.0, 0.0], [0.0, 0.0, 0.0])]
    o = torch.tensor([[x for x in r[0]] for r in rows for _ in range(8)])
    d = torch.tensor([[x for x in r[1]] for r in rows for _ in range(8)])
    alive = torch.zeros(len(o), dtype=torch.bool)
    alive[::8] = True
    got = culling.cull_words_reference(o, d, alive, lo, hi)
    assert torch.equal(got, _torch_prelude(o, d, alive, lo, hi))
    assert got[0, 0] == 0b101 and got[1, 0] == 0 and got[2, 0] == 0


# --- Each word route's entry. ----------------------------------------------


def _tessellated(levels):
    box = tb.scene_from_triangles_txt(BOX_SCENE)
    tris, n = tb.tessellate(box.triangles, box.n_triangles, levels=levels)
    return dataclasses.replace(box, triangles=tris, n_triangles=n,
                               accel=None).with_accel()


@pytest.fixture(scope="module")
def box2560():
    return _tessellated(4)


@pytest.fixture(scope="module")
def box640():
    return _tessellated(3)


def _scene_rays(scene, n_rays=300, alive=True):
    rng = np.random.default_rng(7)
    o = torch.from_numpy(rng.uniform(-4.0, 4.0, (n_rays, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32))
    live = torch.from_numpy(rng.random(n_rays) > 0.3) if alive else None
    return o, d, live


@pytest.mark.parametrize("alive", (True, False))
@pytest.mark.parametrize("case", ("bitmask", "packed", "packed granule 3", "words", "mxu"))
def test_each_word_route_gives_its_torch_words(box2560, case, alive):
    accel = box2560.accel
    o, d, live = _scene_rays(box2560, alive=alive)
    if case == "bitmask":
        got = culling.packet_block_masks(o, d, live, accel)
        want = _torch_block_masks(o, d, live, accel)
    elif case == "mxu":
        got = culling.program_union_words(o, d, live, accel)
        want = _torch_union_words(o, d, live, accel)
        assert torch.equal(got[1], want[1]) and want[1].any()
        got, want = got[0], want[0]
    else:  # tiles of 6 blocks, the last one part filled
        granule = 3 if case.endswith("3") else 1
        if case == "words":
            got = culling.packet_tile_words(o, d, live, accel, 4, 6, granule)
            want = _torch_tile_words(o, d, live, accel, 4, 6, granule)
        else:
            got = culling.packet_tile_words_multi(o, d, live, accel, 4, 6, granule)
            want = _torch_tile_words_multi(o, d, live, accel, 4, 6, granule)
    assert got.shape == want.shape and torch.equal(got, want)
    assert want.any()


def test_words_entry_refuses_a_granule_of_more_than_31_bits(box2560):
    o, d, live = _scene_rays(box2560)
    with pytest.raises(ValueError, match="more than 31 bits"):
        culling.packet_tile_words(o, d, live, box2560.accel, 1, 64, 2)


# --- The route. ------------------------------------------------------------


def _render(scene, **kw):
    return render(scene, Camera.look_at(), 12, 10, spp=2, max_bounce=3, seed=3,
                  pixel_chunk=64, **kw)


def _counted(fn, monkeypatch):
    """``(fn(), counter deltas, wrapper calls)``."""
    calls = []
    real = culling.cull_words

    def spy(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    before = counters()
    monkeypatch.setattr(culling, "cull_words", spy)
    out = fn()
    monkeypatch.setattr(culling, "cull_words", real)
    after = counters()
    return out, {k: after[k] - before[k] for k in after}, calls


def _frozen_counted(fn, monkeypatch):
    """:func:`_counted` with the word routes' entries swapped for their
    frozen torch composition (:data:`FROZEN`)."""
    with monkeypatch.context() as mp:
        for name, entry in FROZEN.items():
            mp.setattr(culling, name, entry)
        return _counted(fn, mp)


def test_a_cpu_call_takes_the_torch_route(box2560, monkeypatch):
    """On the CPU the words are the kernel's plain version (torch), reached
    through the wrapper once a search, with no launch."""
    _, delta, calls = _counted(lambda: _render(box2560), monkeypatch)
    assert delta["search.cull_packets"] > 0
    assert len(calls) == delta["integrator.bounces"] > 0
    assert sum(-(-r // 8) for r in calls) == delta["search.cull_packets"]
    assert delta["launches.cull_words"] == 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_card_route_takes_every_word_search_and_keeps_the_bits(
        box640, route, monkeypatch):
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    way = search.route(box640.n_triangles, box640.accel.n_blocks,
                       search.Knobs.read())
    assert route.startswith(f"{way.kernel} {way.tpu}")
    (img, n), torch_delta, torch_calls = _frozen_counted(lambda: _render(box640),
                                                         monkeypatch)
    (got, m), delta, calls = _counted(lambda: _render(box640), monkeypatch)
    assert torch.equal(_bits(got), _bits(img)) and m == n > 0
    packets = delta["search.cull_packets"]
    assert packets == torch_delta["search.cull_packets"] > 0 and torch_calls == []
    assert delta["launches.cull_words"] == 0  # the CPU branch launches nothing
    if way.kernel == "range":  # its first/last spans are torch slab tests
        assert calls == []
        return
    assert len(calls) == delta["integrator.bounces"]
    assert sum(-(-r // 8) for r in calls) == packets


def test_spd_tetra_keeps_its_bits_and_rays_on_the_card_route(monkeypatch):
    scene = tb.scene_from_triangles_txt(TETRA).with_accel()
    assert search.route(scene.n_triangles, scene.accel.n_blocks,
                        search.Knobs.read()) == search.Route("bitmask", "K2")
    cam = Camera.look_at(origin=(48.0, -48.0, -340.0), target=(0.0, 0.0, 0.0), fov=3.0)

    def frame():
        return render(scene, cam, 16, 12, spp=2, max_bounce=4, seed=11, pixel_chunk=96)

    (img, n), torch_delta, _ = _frozen_counted(frame, monkeypatch)
    (got, m), delta, calls = _counted(frame, monkeypatch)
    assert torch.equal(_bits(got), _bits(img)) and m == n > 0
    assert delta["search.cull_packets"] == torch_delta["search.cull_packets"] > 0
    assert sum(-(-r // 8) for r in calls) == delta["search.cull_packets"]
    assert delta["search.bitmask_blocks"] == torch_delta["search.bitmask_blocks"] > 0
    assert len(calls) == delta["integrator.bounces"]


def test_jvp_and_vmap_through_a_k2_search_on_the_card_route(box2560, monkeypatch):
    tris, n, accel = box2560.triangles, box2560.n_triangles, box2560.accel
    o, d, _ = _scene_rays(box2560, n_rays=64)

    def f(o_):
        return search.search_triangles(o_, d, tris, n, accel=accel)

    want_d, want_i = f(o)
    assert (want_i >= 0).any()
    (dst, idx), (tangent, _) = torch.func.jvp(f, (o,), (torch.ones_like(o),))
    assert torch.equal(_bits(dst), _bits(want_d)) and torch.equal(idx, want_i)
    assert torch.equal(tangent, torch.zeros_like(tangent))

    ob = torch.stack([o, o + 0.25, o - 0.5])
    _, delta, calls = _counted(lambda: torch.func.vmap(f)(ob), monkeypatch)
    got_d, got_i = torch.func.vmap(f)(ob)
    for b in range(3):
        want_d, want_i = f(ob[b])
        assert torch.equal(_bits(got_d[b]), _bits(want_d))
        assert torch.equal(got_i[b], want_i)
    # One call of the route under vmap; the wrapper's body runs per element.
    assert calls == [64] and delta["search.cull_packets"] == 8
    assert delta["launches.cull_words"] == 0


@pytest.mark.parametrize("fault", ("dtype", "shape", "alive shape", "alive dtype",
                                   "contiguity", "device"))
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    rng = np.random.default_rng(1)
    lo, hi = _boxes(rng, 40)
    o, d, _ = _rays(rng, 16, lo, hi, "none")
    alive = None
    if fault == "dtype":
        o = o.double()
    elif fault == "shape":
        d = d[:, :2].contiguous()
    elif fault == "alive shape":
        alive = torch.ones(17, dtype=torch.bool)
    elif fault == "alive dtype":
        alive = torch.ones(16, dtype=torch.int32)
    elif fault == "contiguity":
        lo = torch.empty(3, 40).t().copy_(lo)
    else:
        hi = hi.to("meta")
    with pytest.raises(ValueError, match="cull_words"):
        culling.cull_words(o, d, alive, lo, hi)


def test_the_wrapper_refuses_other_devices():
    x = torch.zeros((8, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        culling.cull_words(x, x, None, x, x)


def test_counters_report_the_wrapper_and_both_routes(monkeypatch):
    """The word routes' launches and every route's packets are counted; no
    counter tells the prelude's routes apart, since there is one."""
    monkeypatch.setattr(culling.cull_words, "launches", 4321)
    snap = counters()
    assert snap["launches.cull_words"] == 4321
    assert "search.cull_packets" in COUNTS and set(COUNTS) <= set(snap)
    assert not [k for k in snap if k.startswith("cull.")]
