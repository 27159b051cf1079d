"""Port parity: the words search (K6, K7) split into work items.

``csrc/search_words.cu`` walks one packet per warp: a packet's blocks, in
walk order (tile, then bit, then block within the bit's granule clipped to
the tile), are cut into work items of at most ``kSplit`` blocks, each item
starts by skipping whole tiles by popcount and then whole bits, and a ray's
items meet in a 64-bit key with ``atomicMin`` (shared with the range
kernel). The kernel runs only on the card, so these tests hold its plain
model (``ops/search_words.py``: ``tile_blocks``, ``words_items``,
``item_blocks``, ``search_words_split``) on the CPU:

* the items partition each packet's block list (``packed_table``): every
  (packet, block) exactly once, in order, at granules that clip a tile's
  last bit, over one to several tiles, with bits past the tile set;
* the kernel's binary search over the scan of the item counts visits each
  (packet, item) once;
* the split walk equals ``search_words_reference`` bit for bit on culled
  words, and on duplicated triangles whose equal-distance copies lie in
  another item and another tile: the lowest original index wins;
* the wrapper's CPU path agrees with the JAX package's interpret-mode K7 at
  a tiling whose granule is 2 with a clipped last bit (indices equal on
  every lane, distances to rtol 1e-6 + atol 1e-5, ROADMAP Queue 3 P1);
* ``kSplit`` of the sources is the ``SPLIT`` of the models, which
  chip_smoke.py holds the count kernels to on the card.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu_torch import tools
from raytracingc_tpu_torch.ops import _build, culling, search
from raytracingc_tpu_torch.ops import search_range as sr
from raytracingc_tpu_torch.ops import search_words as sw
from raytracingc_tpu_torch.ops.accel import BLOCK, build_accel
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute_reference
from raytracingc_tpu_torch.ops.search_packed import packed_table
from raytracingc_tpu_torch.ops.search_words import (
    item_blocks,
    search_words,
    search_words_reference,
    search_words_split,
    tile_blocks,
    words_items,
)
from raytracingc_tpu_torch.tools import packet_sweep, packets, union_walk_ab
from test_torch_accel import port_tris, soup
from test_torch_search_ab import dup_scene  # noqa: F401 (fixture)
from test_torch_search_packet import KNOBS, rays_at

# (blocks per tile, granule): each clips the tile's last bit (5 = 2 + 2 + 1,
# 7 = 3 + 3 + 1, 128 = 25 x 5 + 3, 320 = 29 x 11 + 1), and K3's granule-1
# case, which clips nothing.
CLIPPED = [(5, 2), (7, 3), (128, 5), (320, 11), (31, 1)]
WORDS_KNOBS = {"RTC_STREAM_CULL": "words"}


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _block_lists(words, bpt, granule, split):
    """Per packet: (its block list, the concatenation of its items, the
    item lengths) by the plain model."""
    table = packed_table(words[..., None], bpt, granule)
    counts = tile_blocks(words, bpt, granule).tolist()
    items = words_items(words, bpt, granule, split).tolist()
    out = []
    for p, row in enumerate(words.tolist()):
        parts = [item_blocks(row, counts[p], bpt, granule, split, k)
                 for k in range(items[p] + 1)]
        out.append((torch.nonzero(table[p]).flatten().tolist(),
                    [b for part in parts for b in part], [len(x) for x in parts]))
    return out


@pytest.mark.parametrize("bpt,granule", CLIPPED, ids=[f"{b}/{g}" for b, g in CLIPPED])
@settings(max_examples=60, deadline=None, database=None)
@given(data=st.data())
def test_items_partition_each_packet_block_list(bpt, granule, data):
    """Random words over 1-4 tiles (any int32: bits past the tile's and bit
    31 set too), at splits from 1 to past the list: the items, in order,
    are the packet's block list, each of 1..split blocks, and item
    ``items[p]`` is empty."""
    n_tiles = data.draw(st.integers(1, 4))
    split = data.draw(st.sampled_from([1, 2, 3, 7, 16, 64]))
    rows = data.draw(st.lists(st.lists(st.one_of(
        st.integers(-2**31, 2**31 - 1), st.sampled_from([0, -1, 2**30, 1, 2**31 - 1])),
        min_size=n_tiles, max_size=n_tiles), min_size=1, max_size=6))
    words = torch.tensor(rows, dtype=torch.int32)
    for want, got, lengths in _block_lists(words, bpt, granule, split):
        assert got == want
        assert all(1 <= n <= split for n in lengths[:-1]) and lengths[-1] == 0


@pytest.mark.parametrize("bpt,granule,n_tiles,split", [
    (320, 11, 1, 16), (128, 5, 10, 16), (128, 5, 10, 1), (94, 4, 3, 7)])
def test_items_cover_culled_like_words_and_the_claim_visits_each_once(
        bpt, granule, n_tiles, split):
    """Sparse and dense words at the words routes' tilings (K6 resident at
    40,960 triangles, K7 at 163,840, a ragged 12,000-triangle tile): the
    partition holds, and the kernel's claim (item j belongs to the least p
    with ends[p] > j, as item j - ends[p - 1]) visits every (p, k) once."""
    rs = np.random.default_rng(bpt + n_tiles + split)
    bits = -(-bpt // granule)
    words = np.zeros((517, n_tiles), np.int64)
    for p in range(517):  # 0, 1, a few or every bit of each tile
        for t in range(n_tiles):
            kind = rs.integers(0, 4)
            words[p, t] = (0 if kind == 0 else
                           1 << int(rs.integers(bits)) if kind == 1 else
                           (1 << bits) - 1 if kind == 2 else
                           int(rs.integers(0, 1 << bits)))
    words[::50] = 0  # some packets walk nothing
    words = torch.from_numpy(words.astype(np.int32))
    for want, got, _ in _block_lists(words, bpt, granule, split):
        assert got == want
    items = words_items(words, bpt, granule, split)
    blocks = packed_table(words[..., None], bpt, granule).sum(1)
    assert torch.equal(items.long(), -(-blocks // split)) and (items == 0).any()
    ends = torch.cumsum(items, 0, dtype=torch.int64)
    j = torch.arange(int(ends[-1]))
    pk = torch.searchsorted(ends, j, right=True)
    k = j - torch.cat([torch.zeros(1, dtype=torch.int64), ends])[pk]
    assert torch.equal(torch.bincount(pk, minlength=517), items.long())
    assert len(set(zip(pk.tolist(), k.tolist()))) == j.numel()


def test_split_constants_are_the_kernels():
    """The models' SPLIT is each source's kSplit, and the count kernels'
    packed miss is MISS_KEY."""
    for module, src in ((sr, "search_range.cu"), (sw, "search_words.cu")):
        text = (_build.SRC_DIR / src).read_text()
        assert re.search(r"constexpr int kSplit = (\d+);", text).group(1) == str(module.SPLIT)
    walk = (_build.SRC_DIR / "packet_walk.cuh").read_text()
    hi, lo = re.search(r"kMissKey = \((0x[0-9A-F]+)ull << 32\) \| \(1ull << (\d+)\)",
                       walk).groups()
    assert (int(hi, 16) << 32) | (1 << int(lo)) == sr.MISS_KEY


def _culled(granule, tile):
    """A 1,800-triangle soup (15 blocks) tiled at ``tile`` with the words
    of 1,003 rays (ragged, 30% dead) at ``granule``."""
    jtris, n = soup(1800, seed=21)
    accel = build_accel(port_tris(jtris), n)
    o, d, alive = (torch.from_numpy(x) for x in rays_at(1003, seed=22))
    plane, oi = culling.stream_tile_pad(accel.packed_plane, accel.orig_idx, tile)
    n_tiles, bpt = plane.shape[1] // tile, tile // BLOCK
    words = culling.packet_tile_words(o, d, alive, accel,
                                      n_tiles, bpt, granule)
    return o, d, alive, words, plane, oi


@pytest.mark.parametrize("split", [1, 2, 16])
def test_split_walk_equals_reference_on_culled_words(split):
    """Granule 2 on 5-block tiles (3 tiles, each last bit clipped to one
    block): the split walk equals the plain version bitwise."""
    o, d, alive, words, plane, oi = _culled(2, 640)
    assert (words != 0).any() and (words == 0).any()
    if split < 16:
        assert (words_items(words, 5, 2, split) > 2).any()
    got = search_words_split(o, d, words, plane, oi, 640, 2, split)
    ref = search_words_reference(o, d, words, plane, oi, 640, 2)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert (ref[1][alive] >= 0).sum() > 100


@pytest.mark.parametrize("split", [1, 2, 16])
def test_split_walk_ties_take_the_lowest_index_across_items_and_tiles(split, dup_scene):
    """Every bit set on a shuffled plane of 3-block tiles at granule 2: a
    ray whose winner has an equal-distance copy in another item, and in
    another tile, still gets the original (the C-order scan's winner)."""
    tris, n, o, d, xd, xi = dup_scene
    accel = build_accel(tris, n)
    perm = torch.arange(accel.packed_plane.shape[1])
    perm[:n] = torch.from_numpy(np.random.default_rng(44).permutation(n))
    plane, oi = culling.stream_tile_pad(accel.packed_plane[:, perm].contiguous(),
                                        accel.orig_idx[perm].contiguous(), 384)
    n_tiles = plane.shape[1] // 384  # 3 tiles of 3 blocks: bits 2 + 1
    words = torch.full((-(-o.shape[0] // 8), n_tiles), 0b11, dtype=torch.int32)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = search_words_split(to, td, words, plane, oi, 384, 2, split)
    np.testing.assert_array_equal(got[1].numpy(), xi)
    np.testing.assert_allclose(got[0].numpy(), xd, rtol=1e-6, atol=1e-5)
    ref = search_words_reference(to, td, words, plane, oi, 384, 2)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    col = {int(v): c for c, v in enumerate(oi.tolist()) if v < n}
    blk = lambda i: col[i] // BLOCK
    won = [w for w in xi if 0 <= w < 300]
    assert sum(blk(w) // 3 != blk(w + 600) // 3 for w in won) > 20  # across tiles
    if split < 9:  # 9 blocks: one item at split 16
        assert sum(blk(w) // split != blk(w + 600) // split for w in won) > 20


def test_words_wrapper_matches_interpret_pallas_k7_at_granule_2(monkeypatch):
    """The wrapper's CPU path against the JAX package's K7 in interpret
    mode on a 6,000-triangle soup at 4,992-triangle tiles: 2 tiles of 39
    blocks, granule 2, each tile's last bit clipped to one block."""
    for k, v in {**WORDS_KNOBS, "RTC_STREAM_MAX_T": "256", "RTC_STREAM_TILE": "4992"}.items():
        monkeypatch.setenv(k, v)
    jtris, n = soup(6000, seed=25)
    o, d, alive = rays_at(1003, seed=26)
    jd, ji = (np.asarray(x) for x in ip.search_triangles_pallas(
        jnp.asarray(o), jnp.asarray(d), jtris, interpret=True,
        alive=jnp.asarray(alive), accel=j_build_accel(jtris, n), n_live=n))
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    way = search.route(n, accel.n_blocks, search.Knobs.read())
    assert (way.kernel, way.tpu, way.n_tiles, way.tile, way.granule) == (
        "words", "K7", 2, 4992, 2)
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    words = culling.packet_tile_words(to, td, ta, accel,
                                      way.n_tiles, way.tile // BLOCK, way.granule)
    assert ((words >> 19) & 1).any()  # the clipped bit is walked
    plane, oi = culling.stream_tile_pad(accel.packed_plane, accel.orig_idx, way.tile)
    pd, pi = search_words(to, td, words, plane, oi, way.tile, way.granule)
    np.testing.assert_array_equal(pi.numpy(), ji)  # every lane, dead ones included
    np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-6, atol=1e-5)
    split = search_words_split(to, td, words, plane, oi, way.tile, way.granule, 16)
    assert torch.equal(split[1], pi) and torch.equal(split[0], pd)
    _, bi = search_brute_reference(to, td, pack_triangles(tris, n), n, ta)
    assert torch.equal(pi[ta], bi[ta]) and (pi[ta] >= 0).sum() > 100


@pytest.mark.parametrize("r", [0, 1, 9])
def test_words_wrapper_tiny_and_empty_batches(r):
    jtris, n = soup(300, seed=1)
    accel = build_accel(port_tris(jtris), n)
    o, d, _ = (torch.from_numpy(x) for x in rays_at(max(r, 1), seed=2))
    o, d = o[:r].contiguous(), d[:r].contiguous()
    words = torch.full((-(-r // 8), 1), -1, dtype=torch.int32)  # every bit
    got = search_words(o, d, words, accel.packed_plane, accel.orig_idx, 384, 1)
    assert got[0].shape == got[1].shape == (r,)
    want = search_words_split(o, d, words, accel.packed_plane, accel.orig_idx, 384, 1, 1)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("env,tpu,granule", [
    ({"RTC_BITMASK_MAX_WORDS": "0"}, "K6", 3),
    ({"RTC_STREAM_MAX_T": "4096", "RTC_STREAM_TILE": "4224"}, "K7", 2)])
def test_wide_span_rays_reach_both_ends_of_the_words(env, tpu, granule, monkeypatch):
    """tools/packets.py's wide_span_rays under the words routes on box_scene
    tessellated to 10,240 triangles (80 blocks: one tile at granule 3, last
    bit 2 blocks; 3 tiles of 33 blocks at granule 2, last bit 1 block):
    every 8th packet has the first and the last block in its list; the
    wrapper on them equals the brute scan on live lanes and the split
    walk."""
    for k, v in {**WORDS_KNOBS, **env}.items():
        monkeypatch.setenv(k, v)
    scene = union_walk_ab.load_scene(union_walk_ab.BOX_SCENE, 5, "cpu")
    accel = scene.accel
    way = search.route(scene.n_triangles, accel.n_blocks, search.Knobs.read())
    assert (way.kernel, way.tpu, way.granule) == ("words", tpu, granule)
    o, d, alive = (torch.from_numpy(x) for x in packets.wide_span_rays(
        np.random.default_rng(6), 1003, *packet_sweep.BOX_ORIGINS, accel))
    bpt = way.tile // BLOCK
    words = culling.packet_tile_words(o, d, alive, accel,
                                      way.n_tiles, bpt, way.granule)
    table = packed_table(words[..., None], bpt, way.granule)
    assert (table[:, 0] & table[:, accel.n_blocks - 1])[::8].all()
    plane, oi = culling.stream_tile_pad(accel.packed_plane, accel.orig_idx, way.tile)
    got = search_words(o, d, words, plane, oi, way.tile, way.granule)
    _, bi = search_brute_reference(
        o, d, pack_triangles(scene.triangles, scene.n_triangles), scene.n_triangles, alive)
    assert torch.equal(got[1][alive], bi[alive]) and (bi[alive] >= 0).sum() > 150
    split = search_words_split(o, d, words, plane, oi, way.tile, way.granule, 16)
    assert torch.equal(split[1], got[1]) and torch.equal(split[0], got[0])


@pytest.mark.parametrize("env,tpu", [(WORDS_KNOBS, "K6"),
                                     ({**WORDS_KNOBS, "RTC_STREAM_MAX_T": "1024",
                                       "RTC_STREAM_TILE": "768"}, "K7")])
def test_packet_sweep_times_the_words_route(env, tpu):
    """packet_sweep's words cases take the dispatch's words route; its
    wrapper call equals its plain call (both the plain version here), and
    its one-warp-per-packet yardstick (K3's kernel on the same words) too."""
    scene = union_walk_ab.load_scene(union_walk_ab.BOX_SCENE, 4, "cpu")
    o, d, alive = (torch.from_numpy(x) for x in packets.secondary_rays(
        np.random.default_rng(7), 512, *packet_sweep.BOX_ORIGINS))
    with tools.knobs_set({"RTC_BITMASK_MAX_WORDS": "0", **env}):
        way, wrapper, plain, pairs = packet_sweep.case_calls(scene, o, d, alive)
        packet = packet_sweep.packet_walk_call(scene, o, d, alive)
    assert (way.kernel, way.tpu) == ("words", tpu)
    (wd, wi), (pd, pi), (kd, ki) = wrapper(), plain(), packet()
    assert torch.equal(wi, pi) and torch.equal(wd, pd)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    assert pairs % (8 * BLOCK) == 0 and pairs > 0
