"""Port parity: the range search (K4, K5) split into work items.

``csrc/search_range.cu`` cuts each packet's clipped block span into work
items of at most ``kSplit`` blocks, walks each item in one warp and merges a
ray's items through a 64-bit key ``bits(dst) << 32 | orig_idx`` with
``atomicMin``; its count kernel fills the keys with ``MISS_KEY``, and a CUDA
unpack whose plain version is ``unpack_keys`` turns them into the wrapper's
output (both held to these on the card by chip_smoke.py). The kernel runs
only on the card, so these tests hold
its plain model (``ops/search_range.py``: ``range_items``, ``item_table``,
``search_range_split``) and the wrapper's key helpers on the CPU:

* the key orders exactly like (dst, idx) lexicographically, and unpacks to
  the wrapper's output, edge values included;
* the items partition every clipped span, and the kernel's binary search
  over the scan of the item counts visits each (packet, item) once;
* the split walk equals ``search_range_reference`` bit for bit, also when
  duplicated triangles, at equal distances, lie in different items: the
  lowest original index wins across an item boundary;
* the wrapper's CPU path agrees with the JAX package's interpret-mode K5
  (indices equal on every lane, distances to rtol 1e-6 + atol 1e-5, as in
  test_torch_search_ab.py: XLA:CPU contracts multiply-adds into FMA, ROADMAP
  Queue 3 P1);
* the C entry points of ``csrc/*.cu`` match the ``ctypes`` signatures that
  ``ops/_build.py`` binds them with.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu_torch.ops import _build, culling, search
from raytracingc_tpu_torch.ops.accel import BLOCK, PAD_ORIG_IDX, build_accel
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute_reference
from raytracingc_tpu_torch.ops.search_range import (
    MISS_KEY,
    item_table,
    pack_keys,
    range_items,
    range_table,
    search_range,
    search_range_reference,
    search_range_split,
    unpack_keys,
)
from raytracingc_tpu_torch.scene.types import EPSILON, MISS_DST
from raytracingc_tpu_torch import tools
from raytracingc_tpu_torch.tools import packet_sweep, packets, union_walk_ab
from test_torch_accel import port_tris, soup
from test_torch_search_ab import TINY_STREAM, dup_scene  # noqa: F401 (fixture)
from test_torch_search_packet import KNOBS, rays_at

EMPTY = (2**30, -1)  # the empty span (culling.EMPTY_FIRST, -1)


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _keys(pairs):
    dst = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    idx = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    return dst, idx, pack_keys(dst, idx)


def _assert_key_order(pairs):
    """Sorting by key sorts by (dst, idx); equal keys iff equal pairs; the
    keys unpack to the pairs, idx -1 where dst is MISS_DST."""
    dst, idx, keys = _keys(pairs)
    lex = sorted(range(len(pairs)), key=lambda i: (float(dst[i]), int(idx[i])))
    by_key = sorted(range(len(pairs)), key=lambda i: int(keys[i]))
    as_lex = lambda order: [(float(dst[i]), int(idx[i])) for i in order]
    assert as_lex(by_key) == as_lex(lex)
    k = keys.tolist()
    for i in range(len(pairs)):
        for j in range(len(pairs)):
            assert (k[i] == k[j]) == (as_lex([i]) == as_lex([j]))
    got_d, got_i = unpack_keys(keys)
    assert torch.equal(got_d.view(torch.int32), dst.view(torch.int32))
    assert torch.equal(got_i, torch.where(dst < MISS_DST, idx, -1))


_f32 = lambda x: float(np.float32(x))
EDGE_DST = (0.0, _f32(EPSILON), float(np.nextafter(np.float32(EPSILON), np.float32(1))),
            1.0, float(np.nextafter(np.float32(MISS_DST), np.float32(0))), _f32(MISS_DST))
EDGE_IDX = (0, 1, 2**30 - 1, 2**30)


@pytest.mark.parametrize("dst", EDGE_DST, ids=["zero", "epsilon", "above_epsilon", "one",
                                                "below_miss", "miss"])
def test_key_order_at_edge_values(dst):
    """Every edge distance against every edge distance, each with every edge
    index."""
    _assert_key_order([(dst, i) for i in EDGE_IDX]
                      + [(e, i) for e in EDGE_DST for i in (0, 2**30)])


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.tuples(
    st.one_of(st.floats(min_value=0.0, max_value=MISS_DST, width=32,
                        allow_nan=False).map(abs),
              st.sampled_from(EDGE_DST)),
    st.one_of(st.integers(0, 2**30), st.sampled_from(EDGE_IDX))),
    min_size=2, max_size=24))
def test_key_order_equals_lex_order(pairs):
    _assert_key_order(pairs)


def test_miss_key_is_the_packed_miss_and_loses_to_every_key():
    dst, idx, keys = _keys([(MISS_DST, PAD_ORIG_IDX)])
    assert int(keys[0]) == MISS_KEY == (0x497423F0 << 32) | 2**30
    d, i = unpack_keys(torch.full((3,), MISS_KEY, dtype=torch.int64))
    assert (d == MISS_DST).all() and (i == -1).all()
    _, _, others = _keys([(e, i) for e in EDGE_DST for i in EDGE_IDX])
    assert int(others.max()) == MISS_KEY and (others <= MISS_KEY).all()


def _spans(n_packets, n_blocks, seed):
    """Random spans over and past an ``n_blocks`` plane: ordinary ones, empty
    ones, ones past either end, single blocks and the whole plane."""
    rs = np.random.default_rng(seed)
    first = rs.integers(0, n_blocks + 3, n_packets)
    last = first + rs.integers(-2, n_blocks + 2, n_packets)
    kind = rs.integers(0, 6, n_packets)
    first = np.where(kind == 0, EMPTY[0], first)
    last = np.where(kind == 0, EMPTY[1], last)
    first = np.where(kind == 1, 0, first)
    last = np.where(kind == 1, n_blocks - 1, last)
    last = np.where(kind == 2, first, last)
    return (torch.from_numpy(first.astype(np.int32)),
            torch.from_numpy(last.astype(np.int32)))


@pytest.mark.parametrize("n_rays,n_blocks,split", [
    (1003, 15, 1), (1003, 15, 4), (1003, 15, 16), (64, 1, 16),
    (517, 1280, 16), (8, 40, 7), (100003, 320, 16)])
def test_items_partition_each_clipped_span(n_rays, n_blocks, split):
    p = -(-n_rays // 8)  # ragged R: the last packet is partial
    first, last = _spans(p, n_blocks, seed=n_rays + n_blocks + split)
    items = range_items(first, last, n_blocks, split)
    clipped = range_table(first.clamp(min=0), last.clamp(max=n_blocks - 1), n_blocks)
    assert torch.equal(clipped, range_table(first, last, n_blocks))
    width = clipped.sum(1)
    assert torch.equal(items.long(), -(-width // split))  # 0 for empty spans
    assert (items[first > last] == 0).all() and (items[first >= n_blocks] == 0).all()
    covered = torch.zeros_like(clipped, dtype=torch.int32)
    for k in range(int(items.max()) + 1):
        t = item_table(first, last, n_blocks, split, k)
        assert torch.equal(t.any(1), k < items)  # item k exists iff k < items
        assert (t.sum(1) <= split).all()
        covered += t.int()
    assert torch.equal(covered, clipped.int())  # no block twice, none missed

    # The kernel's claim: item j belongs to the least p with ends[p] > j,
    # as the k = j - ends[p - 1]-th item of p. Every (p, k) exactly once.
    ends = torch.cumsum(items, 0, dtype=torch.int64)
    j = torch.arange(int(ends[-1]))
    pk = torch.searchsorted(ends, j, right=True)
    k = j - torch.cat([torch.zeros(1, dtype=torch.int64), ends])[pk]
    assert torch.equal(torch.bincount(pk, minlength=p), items.long())
    assert ((k >= 0) & (k < items.long()[pk])).all()
    assert len(set(zip(pk.tolist(), k.tolist()))) == j.numel()


def _shuffled_plane(accel, n_live, seed):
    """The accel's plane with its live columns in a random order: the
    duplicates of the dup scene, adjacent in Morton order, land in
    different blocks (the kernel takes any plane; spans are block ranges)."""
    perm = torch.arange(accel.packed_plane.shape[1])
    perm[:n_live] = torch.from_numpy(np.random.default_rng(seed).permutation(n_live))
    return accel.packed_plane[:, perm].contiguous(), accel.orig_idx[perm].contiguous()


@pytest.mark.parametrize("split", [1, 2, 3])
def test_split_walk_ties_take_the_lowest_index_across_items(split, dup_scene):
    """On whole-plane spans of a shuffled plane, a ray whose winner has an
    equal-distance copy in another work item still gets the original, the
    C-order scan's winner; the split walk equals the plain version bitwise."""
    tris, n, o, d, xd, xi = dup_scene
    accel = build_accel(tris, n)
    plane, oi = _shuffled_plane(accel, n, seed=43)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    p = -(-o.shape[0] // 8)
    first = torch.zeros(p, dtype=torch.int32)
    last = torch.full((p,), accel.n_blocks - 1, dtype=torch.int32)
    got = search_range_split(to, td, first, last, plane, oi, split)
    ref = search_range_reference(to, td, first, last, plane, oi)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    np.testing.assert_array_equal(got[1].numpy(), xi)
    np.testing.assert_allclose(got[0].numpy(), xd, rtol=1e-6, atol=1e-5)
    # Rays won by an original whose copy (600 later) lies in another item.
    col = {int(v): c for c, v in enumerate(oi.tolist()) if v < n}
    item = lambda i: col[i] // BLOCK // split
    crossed = sum(1 for w in xi if 0 <= w < 300 and item(w) != item(w + 600))
    assert crossed > 20


@pytest.mark.parametrize("split", [1, 2, 5])
def test_split_walk_equals_reference_on_culled_spans(split):
    """The culling prelude's spans on a soup, dead lanes and a ragged last
    packet included: the split walk equals the plain version bitwise."""
    jtris, n = soup(1800, seed=21)  # 15 blocks
    accel = build_accel(port_tris(jtris), n)
    o, d, alive = (torch.from_numpy(x) for x in rays_at(1003, seed=22))
    first, last = culling.packet_block_ranges(*culling.packets(o, d, alive), accel)
    assert (first > last).any() and (range_items(first, last, accel.n_blocks, split) > 1).any()
    got = search_range_split(o, d, first, last, accel.packed_plane, accel.orig_idx, split)
    ref = search_range(o, d, first, last, accel.packed_plane, accel.orig_idx)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))


def test_range_wrapper_matches_interpret_pallas_k5(monkeypatch):
    """The wrapper's CPU path against the JAX package's K5 in interpret
    mode on a 1,800-triangle soup, 256-triangle tiles, ragged R."""
    for k, v in {"RTC_CULL": "range", **TINY_STREAM}.items():
        monkeypatch.setenv(k, v)
    jtris, n = soup(1800, seed=21)
    o, d, alive = rays_at(1003, seed=22)
    jd, ji = (np.asarray(x) for x in ip.search_triangles_pallas(
        jnp.asarray(o), jnp.asarray(d), jtris, interpret=True,
        alive=jnp.asarray(alive), accel=j_build_accel(jtris, n), n_live=n))
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    way = search.route(n, accel.n_blocks, search.Knobs.read())
    assert (way.kernel, way.tpu, way.n_tiles) == ("range", "K5", 8)
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    first, last = culling.packet_block_ranges(*culling.packets(to, td, ta), accel)
    plane, oi = culling.stream_tile_pad(accel.packed_plane, accel.orig_idx, way.tile)
    pd, pi = search_range(to, td, first, last, plane, oi)
    np.testing.assert_array_equal(pi.numpy(), ji)  # every lane, dead ones included
    np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-6, atol=1e-5)
    split = search_range_split(to, td, first, last, plane, oi, 2)
    assert torch.equal(split[1], pi) and torch.equal(split[0], pd)
    _, bi = search_brute_reference(to, td, pack_triangles(tris, n), n, ta)
    assert torch.equal(pi[ta], bi[ta]) and (pi[ta] >= 0).sum() > 100


@pytest.mark.parametrize("r", [0, 1, 9])
def test_range_wrapper_tiny_and_empty_batches(r):
    jtris, n = soup(300, seed=1)
    accel = build_accel(port_tris(jtris), n)
    o, d, _ = (torch.from_numpy(x) for x in rays_at(max(r, 1), seed=2))
    o, d = o[:r].contiguous(), d[:r].contiguous()
    p = -(-r // 8)
    first = torch.zeros(p, dtype=torch.int32)
    last = torch.full((p,), 99, dtype=torch.int32)  # past the plane
    dst, idx = search_range(o, d, first, last, accel.packed_plane, accel.orig_idx)
    assert dst.shape == idx.shape == (r,)
    want = search_range_split(o, d, first, last, accel.packed_plane, accel.orig_idx, 1)
    assert torch.equal(idx, want[1]) and torch.equal(dst, want[0])


def test_wide_span_rays_span_the_whole_plane():
    """tools/packets.py's wide_span_rays: every 8th packet's span is the
    whole plane; the range route on them equals the brute scan on live
    lanes, and the split walk equals the wrapper."""
    scene = union_walk_ab.load_scene(union_walk_ab.BOX_SCENE, 4, "cpu")  # 20 blocks
    accel = scene.accel
    o, d, alive = (torch.from_numpy(x) for x in packets.wide_span_rays(
        np.random.default_rng(6), 2003, *packet_sweep.BOX_ORIGINS, accel))
    first, last = culling.packet_block_ranges(*culling.packets(o, d, alive), accel)
    whole = (first == 0) & (last == accel.n_blocks - 1)
    assert whole[::8].all() and whole.sum() >= first.numel() // 8
    got = search_range(o, d, first, last, accel.packed_plane, accel.orig_idx)
    _, bi = search_brute_reference(
        o, d, pack_triangles(scene.triangles, scene.n_triangles), scene.n_triangles, alive)
    assert torch.equal(got[1][alive], bi[alive]) and (bi[alive] >= 0).sum() > 300
    split = search_range_split(o, d, first, last, accel.packed_plane, accel.orig_idx, 3)
    assert torch.equal(split[1], got[1]) and torch.equal(split[0], got[0])


@pytest.mark.parametrize("env,tpu", [({"RTC_CULL": "range"}, "K4"),
                                     ({"RTC_CULL": "range", "RTC_STREAM_MAX_T": "1024",
                                       "RTC_STREAM_TILE": "768"}, "K5")])
def test_packet_sweep_times_the_range_route(env, tpu, monkeypatch):
    """packet_sweep's range cases take the dispatch's range route, and its
    wrapper call equals its plain call (both the plain version here)."""
    scene = union_walk_ab.load_scene(union_walk_ab.BOX_SCENE, 4, "cpu")
    o, d, alive = (torch.from_numpy(x) for x in packets.secondary_rays(
        np.random.default_rng(7), 512, *packet_sweep.BOX_ORIGINS))
    with tools.knobs_set(env):
        way, wrapper, plain, pairs = packet_sweep.case_calls(scene, o, d, alive)
    assert (way.kernel, way.tpu) == ("range", tpu)
    (wd, wi), (pd, pi) = wrapper(), plain()
    assert torch.equal(wi, pi) and torch.equal(wd, pd)
    assert pairs % (8 * BLOCK) == 0 and pairs > 0
    assert not any(k in os.environ for k in env)  # the knobs are restored


_C_TYPES = {"int": ctypes.c_int, "const char*": ctypes.c_char_p}


def test_c_entry_points_match_their_ctypes_signatures():
    """Every ``extern "C"`` function of csrc/*.cu is bound in _SIGNATURES
    with one argtype per parameter (a pointer as c_void_p, an int as c_int)
    and its return type; nothing else is bound."""
    found = {}
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        text = src.read_text()
        for ret, name, params in re.findall(
                r"^(int|const char\*) (rtc_\w+)\(([^)]*)\)", text, re.M):
            types = [_build._VOID_P if "*" in p else _build._INT
                     for p in (x.strip() for x in params.split(","))]
            found[name] = (types, _C_TYPES[ret])
    assert found == dict(_build._SIGNATURES)
