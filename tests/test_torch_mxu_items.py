"""Port parity: the pieces of the program-union kernels' Hopper design.

``csrc/search_mxu.cu`` (K8) packs the four comparison planes into a bf16
table in the ``mma.sync`` m16n8k16 A-fragment order, cuts each program's
work into items (program, ray slice, run of union blocks) and merges a
ray's items through 64-bit keys; the union walk (K9) runs the words kernel
with one word row per program. The kernels run only on the card, so these
tests hold their plain models on the CPU:

* ``mxu_fragments`` against an independent decoding of the PTX A-fragment
  map: every (plane, part, row, column) comes back as the round-to-nearest
  bf16 part of the table (a layout with two registers swapped fails);
* the items partition every (program, ray slice, union block) exactly once,
  over random words, flags, ray counts and block counts (hypothesis);
* the item walk with the key merge (``search_mxu_split``) equals
  ``search_mxu_reference`` bit for bit at several splits, in both
  precisions, on culled words and on equal-distance copies in other items
  (the lowest original index wins);
* the union walk's plain version equals the words search on the rows the
  packets read, bit for bit;
* the sources' constants are the models'.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raytracingc_tpu_torch.ops import _build, culling
from raytracingc_tpu_torch.ops import intersect_mxu as pm
from raytracingc_tpu_torch.ops.accel import BLOCK, build_accel
from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table
from raytracingc_tpu_torch.ops.search_union import (
    search_union,
    search_union_reference,
    search_union_words,
    union_rows,
)
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.scene.types import MISS_DST
from test_torch_accel import port_tris, soup
from test_torch_search_packet import rays_at


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_parts(x, parts):
    """numpy float32 → ``parts`` uint16 bf16 parts, each the round-to-nearest-
    even bf16 of the residual (finite inputs), by bit arithmetic."""
    out = []
    x = x.astype(np.float32)
    for _ in range(parts):
        u = x.view(np.uint32).astype(np.uint64)
        h = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        out.append(h)
        x = (x - (h.astype(np.uint32) << 16).view(np.float32)).astype(np.float32)
    return out


@pytest.mark.parametrize("parts", [2, 3])
def test_fragments_follow_the_ptx_a_fragment_map(parts):
    """PTX ISA, mma.m16n8k16 with .bf16 A: four .b32 registers a0..a3 of two
    elements each; with groupID = laneid >> 2 and threadID_in_group =
    laneid % 4, a0 and a2 hold row groupID, a1 and a3 row groupID + 8, and
    element j (0, 1) of a0, a1 column 2 threadID_in_group + j, of a2, a3
    that + 8. Tile k of a block is its rows 16 k .. 16 k + 15."""
    jtris, n = soup(300, seed=5)  # 3 blocks
    accel = build_accel(port_tris(jtris), n)
    coeffs = accel.mxu_coeffs
    got = pm.mxu_fragments(coeffs, parts).numpy().view(np.uint16)
    n_blocks = coeffs.shape[0] // pm.ROWS_PER_BLOCK
    assert got.shape == (n_blocks, 4, parts, 8, 32, 8)
    assert got.nbytes == n_blocks * parts * pm.FRAG_BYTES
    planes = coeffs.numpy().reshape(n_blocks, 6, BLOCK, 16)[:, :4]
    want = np.stack(_bf16_parts(planes, parts), 2)  # [B, 4, parts, 128, 16]
    for lane in range(32):
        group, tig = lane >> 2, lane % 4
        for reg in range(4):
            row = group + (8 if reg in (1, 3) else 0)
            for j in range(2):
                col = 2 * tig + j + (8 if reg in (2, 3) else 0)
                for tile in range(8):
                    np.testing.assert_array_equal(
                        got[:, :, :, tile, lane, 2 * reg + j],
                        want[:, :, :, 16 * tile + row, col])
    # Every part is non-trivial somewhere, and two parts are split_bf16's.
    assert all((want[:, :, p] != 0).any() for p in range(parts))
    hi, lo = (x.view(torch.int16).numpy().view(np.uint16)
              for x in pm.split_bf16(torch.from_numpy(planes)))
    np.testing.assert_array_equal(want[:, :, 0], hi)
    np.testing.assert_array_equal(want[:, :, 1], lo)


@settings(max_examples=80, deadline=None, database=None)
@given(data=st.data())
def test_items_partition_each_program_slice_and_block(data):
    """Random words (any int32: bits past the plane and bit 31 set too),
    flags, ray counts and block counts: the items of each program, in
    order, cover every (ray slice, union block) once, each a run of 1..split
    blocks in ascending order, none for a program whose flag is 0; and the
    kernel's claim over the scan visits every (program, item) once."""
    g = data.draw(st.integers(1, 4))
    n_words = data.draw(st.integers(1, 3))
    n_blocks = data.draw(st.integers(1, 31 * n_words))
    n_rays = data.draw(st.integers(1024 * (g - 1) + 1, 1024 * g))
    split = data.draw(st.sampled_from([1, 2, 3, pm.SPLIT, 7, 64]))
    slice_ = data.draw(st.sampled_from([16, pm.SLICE, 64, 1024]))
    word = st.one_of(st.integers(-2**31, 2**31 - 1),
                     st.sampled_from([0, -1, 1, 2**30, 2**31 - 1]))
    words = torch.tensor(data.draw(st.lists(st.lists(
        word, min_size=n_words, max_size=n_words), min_size=g, max_size=g)),
        dtype=torch.int32)
    flags = torch.tensor(data.draw(st.lists(st.integers(0, 1), min_size=g,
                                            max_size=g)), dtype=torch.int32)
    items = pm.mxu_items(words, flags, n_rays, n_blocks, split, slice_)
    table = bitmask_table(words, n_blocks)
    for p in range(g):
        rays = min(n_rays - 1024 * p, 1024)
        union = torch.nonzero(table[p]).flatten().tolist()
        want = ({(s, b) for s in range(-(-rays // slice_)) for b in union}
                if flags[p] else set())
        got = []
        for k in range(int(items[p])):
            s, blocks = pm.mxu_item(words[p].tolist(), rays, n_blocks, split,
                                    slice_, k)
            assert 1 <= len(blocks) <= split and blocks == sorted(blocks)
            got += [(s, b) for b in blocks]
        assert len(got) == len(set(got)) and set(got) == want
    ends = torch.cumsum(items, 0, dtype=torch.int64)
    j = torch.arange(int(ends[-1]))
    prog = torch.searchsorted(ends, j, right=True)
    k = j - torch.cat([torch.zeros(1, dtype=torch.int64), ends])[prog]
    assert torch.equal(torch.bincount(prog, minlength=g), items.long())
    assert len(set(zip(prog.tolist(), k.tolist()))) == j.numel()


@pytest.fixture(scope="module")
def culled():
    """A 600-triangle soup (5 blocks) and 2,600 rays (30% dead lanes, the
    last program ragged and all dead: its flag is 0) with their program
    union words, and the plain version's result in both precisions."""
    jtris, n = soup(600, seed=31)
    accel = build_accel(port_tris(jtris), n)
    o, d, alive = (torch.from_numpy(x) for x in rays_at(2600, seed=32))
    alive[2048:] = False
    words, flags = culling.program_union_words(o, d, alive, accel)
    assert flags.tolist() == [1, 1, 0]
    assert (bitmask_table(words, accel.n_blocks).sum(1)[:2] > pm.SPLIT).all()
    args = (o, d, words, flags, accel.mxu_coeffs, accel.orig_idx)
    ref = {prec: pm.search_mxu_reference(*args, prec, alive) for prec in pm.PRECISIONS}
    return args, alive, ref


def _assert_bitwise(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("precision", pm.PRECISIONS)
@pytest.mark.parametrize("split", [1, 2, pm.SPLIT])
def test_split_walk_equals_reference_on_culled_words(split, precision, culled):
    args, alive, ref = culled
    got = pm.search_mxu_split(*args, precision, alive, split)
    _assert_bitwise(got, ref[precision])
    assert (ref[precision][1][alive] >= 0).sum() > 100
    assert (got[1][~alive] == -1).all() and (got[0][~alive] == MISS_DST).all()


@pytest.mark.parametrize("precision", pm.PRECISIONS)
@pytest.mark.parametrize("split", [1, 2, pm.SPLIT])
def test_split_walk_ties_take_the_lowest_index_across_items(split, precision):
    """The tie fixture of test_torch_mxu.py's
    test_tie_takes_the_lowest_original_index spread over three blocks: the
    two equal-distance copies in blocks 0 (original index 9) and 2 (index
    4), the copy moved behind in block 1 (index 1). At splits 1 and 2 the
    copies lie in different items, which meet only in the keys: index 4
    wins on every live lane."""
    tri = np.array([[-2, -2, 3], [2, -2, 3], [0, 2, 3]], np.float32)
    verts = np.zeros((3 * BLOCK, 3, 3), np.float32)  # zero triangles: never valid
    slots = {5: 9, BLOCK + 3: 1, 2 * BLOCK + 77: 4}
    verts[list(slots)] = tri
    verts[BLOCK + 3, :, 2] = 5.0
    nrm = -np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    tris, _ = tb.triangles_from_arrays(
        verts, nrm, np.full((3 * BLOCK, 3), 0.5, np.float32),
        np.zeros(3 * BLOCK, np.float32), np.zeros(3 * BLOCK, np.float32))
    orig_idx = torch.arange(3 * BLOCK, dtype=torch.int32) + 100
    orig_idx[list(slots)] = torch.tensor(list(slots.values()), dtype=torch.int32)
    coeffs = pm.pack_coeffs_mxu(tris, orig_idx)
    r = 1100
    o = torch.zeros((r, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(r, 1)
    alive = torch.arange(r) % 5 != 0
    words = torch.full((2, 1), 0b111, dtype=torch.int32)
    flags = torch.ones(2, dtype=torch.int32)
    args = (o, d, words, flags, coeffs, orig_idx, precision, alive)
    got = pm.search_mxu_split(*args, split)
    _assert_bitwise(got, pm.search_mxu_reference(*args))
    assert (got[1][alive] == 4).all() and (got[0][alive] == 3.0).all()
    assert (got[1][~alive] == -1).all()


def _union_case(n_tris, r, seed):
    jtris, n = soup(n_tris, seed=seed)
    accel = build_accel(port_tris(jtris), n)
    o, d, alive = (torch.from_numpy(x) for x in rays_at(r, seed=seed + 1))
    words, flags = culling.program_union_words(o, d, alive, accel)
    return o, d, words, flags, accel.packed_plane, accel.orig_idx


@pytest.mark.parametrize("n_tris,r", [(600, 1500), (4500, 2100)],
                         ids=["5 blocks, 1 word", "36 blocks, 2 words"])
def test_union_walk_is_the_words_search_on_program_rows(n_tris, r):
    """search_union_reference equals the plain words search on each
    packet's program row (granule 1, tiles of 31 blocks, the plane padded
    to whole tiles), bit for bit, and so does the wrapper's CPU path."""
    args = _union_case(n_tris, r, seed=n_tris)
    want = search_union_reference(*args)
    _assert_bitwise(search_union_words(*args), want)
    _assert_bitwise(search_union(*args), want)
    assert (want[1] >= 0).sum() > 100


def test_union_rows_clear_what_the_reference_ignores():
    """Bits past the plane's last block, bit 31 and the words of a program
    whose flag is 0 test nothing in the reference; the rows the kernel reads
    have them cleared, and the words search on them still equals it."""
    o, d, words, flags, plane, oi = _union_case(4500, 2100, seed=4500)  # 36 blocks
    junk = words | torch.tensor([[1 << 31, (1 << 31) | (1 << 20)]],
                                dtype=torch.int64).to(torch.int32)
    junk[2] = -1
    flags = flags.clone()
    flags[2] = 0
    rows = union_rows(junk, flags, plane.shape[1] // BLOCK)
    assert torch.equal(rows[:2], words[:2] & torch.tensor([2**31 - 1, (1 << 5) - 1],
                                                          dtype=torch.int32))
    assert (rows[2] == 0).all()
    args = (o, d, junk, flags, plane, oi)
    want = search_union_reference(*args)
    _assert_bitwise(search_union_words(*args), want)
    assert (want[1][2048:] == -1).all()


def test_constants_are_the_sources():
    """kSlice and kSplit of search_mxu.cu are SLICE and SPLIT of the model;
    the words kernel's program rows are PACKETS_PER_PROGRAM packets."""
    mxu = (_build.SRC_DIR / "search_mxu.cu").read_text()
    assert int(re.search(r"constexpr int kSlice = (\d+);", mxu).group(1)) == pm.SLICE
    assert int(re.search(r"constexpr int kSplit = (\d+);", mxu).group(1)) == pm.SPLIT
    words = (_build.SRC_DIR / "search_words.cu").read_text()
    assert int(re.search(r"constexpr int kProgramPackets = (\d+);", words).group(1)) == (
        culling.PACKETS_PER_PROGRAM)
    assert pm.FRAG_BYTES == 4 * 8 * 32 * 16
