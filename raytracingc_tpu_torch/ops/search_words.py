"""One-word-per-tile packet search (K6, K7): the CUDA kernel and its plain
version.

Counterpart of
``raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_streamed_words``
(ray-major grid; also the resident words route, one tile of the whole
plane) and of ``_search_kernel_streamed_words_tmajor`` (tile-major grid,
with the cross-tile lex-min fold of its launcher). The two differ only in
grid order, which has no meaning on the card, so ``csrc/search_words.cu``
serves both (``RTC_STREAM_ORDER`` only names the TPU kernel).
:func:`search_words_reference` is its plain PyTorch version, used on CPU
tensors and by the tests and ``chip_smoke.py`` to hold the kernel against.

Inputs: rays ``o, d [R, 3]`` float32; culling words ``[ceil(R / 8),
n_tiles]`` int32 from ``ops/culling.py::packet_tile_words``; the ``[12,
n_tiles * tile]`` plane and ``orig_idx`` padded to whole tiles
(``culling.stream_tile_pad``); the tile size and the culling ``granule``,
which must leave at most 31 bits per tile. Bit ``j`` of tile ``t``'s word
covers the tile-local blocks ``[j * granule, ... + granule)`` clipped to the
tile. Each ray keeps the lexicographic minimum of (dst, original index)
over the blocks of its packet's set bits; dead lanes are not masked (see
``search_bitmask``). Returns ``dst [R]`` float32 and ``idx [R]`` int32 (-1
on a miss).

The kernel walks one packet per warp, as the range kernel does: a packet's
blocks, in walk order (tile, then bit, then block within the bit's clipped
granule), are cut into work items of at most ``kSplit`` = :data:`SPLIT`
blocks, each walked by one warp and merged into the rays' 64-bit keys
(``search_range.item_search``). :func:`tile_blocks`, :func:`words_items`,
:func:`item_blocks` and :func:`search_words_split` are the plain model of
that work list and split walk at any split, down to the kernel's skip to an
item's first block: the tests hold the model to the packet's block list
(:func:`~raytracingc_tpu_torch.ops.search_packed.packed_table`) and to
:func:`search_words_reference`.
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.ops.search_bitmask import search_blocks_reference
from raytracingc_tpu_torch.ops.search_packed import check_tiled_args, packed_table
from raytracingc_tpu_torch.ops.search_range import (
    MISS_KEY,
    item_search,
    pack_keys,
    unpack_keys,
)

SPLIT = 16  # kSplit of csrc/search_words.cu: blocks per work item


def search_words_reference(o, d, words, plane, orig_idx, tile: int,
                           granule: int):
    """Plain PyTorch version of the words kernel (same inputs, same bits)."""
    table = packed_table(words[..., None], tile // BLOCK, granule)
    return search_blocks_reference(o, d, plane, orig_idx, table)


def tile_blocks(words, blocks_per_tile: int, granule: int):
    """``[P, n_tiles]`` words → ``[P, n_tiles]`` int32, the blocks each word
    covers, by the kernel's arithmetic (``csrc/search_words.cu::
    tile_blocks``): ``granule`` for each set bit among the tile's
    ``ceil(blocks_per_tile / granule)`` bits, less what the last bit lacks
    when it is set and clipped to the tile."""
    n = -(-blocks_per_tile // granule)
    m = words & ((1 << n) - 1)
    shifts = torch.arange(n, dtype=torch.int32, device=words.device)
    pop = ((m[..., None] >> shifts) & 1).sum(-1)
    last = (m >> (n - 1)) & 1
    return (pop * granule - last * (n * granule - blocks_per_tile)).to(torch.int32)


def words_items(words, blocks_per_tile: int, granule: int, split: int):
    """Work items per packet, ``[P]`` int32: ``ceil(blocks / split)`` of the
    packet's blocks over all its tiles. The plain version of
    ``csrc/search_words.cu::words_items_kernel`` (``split = kSplit``)."""
    blocks = tile_blocks(words, blocks_per_tile, granule).sum(1)
    return (-(-blocks // split)).to(torch.int32)


def item_blocks(row, counts, blocks_per_tile: int, granule: int, split: int,
                k: int) -> list[int]:
    """Global blocks (``t * blocks_per_tile + b``) of work item ``k`` of one
    packet, whose words are ``row`` and whose :func:`tile_blocks` are
    ``counts`` (int lists over its tiles), step by step as the kernel walks
    them (``WordItems::begin`` and ``rtc::BlockCursor::next``): skip whole
    tiles by their counts, then ``s // granule`` set bits of the item's
    tile, start ``s % granule`` blocks into the next, and walk at most
    ``split`` blocks in order, bits past a tile covering nothing."""
    s = k * split
    t = 0
    while t < len(row) and s >= counts[t]:
        s -= counts[t]
        t += 1
    if t == len(row):
        return []
    m = row[t] & ((1 << -(-blocks_per_tile // granule)) - 1)
    for _ in range(s // granule):
        m &= m - 1
    start = ((m & -m).bit_length() - 1) * granule
    m &= m - 1
    b, end = start + s % granule, min(start + granule, blocks_per_tile)
    out = []
    while len(out) < split:
        while b >= end:
            while m == 0:
                t += 1
                if t == len(row):
                    return out
                m = row[t] & 0xFFFFFFFF
            start = ((m & -m).bit_length() - 1) * granule
            m &= m - 1
            b, end = start, min(start + granule, blocks_per_tile)
        out.append(t * blocks_per_tile + b)
        b += 1
    return out


def item_table(words, blocks_per_tile: int, granule: int, split: int, k: int):
    """``[P, n_tiles * blocks_per_tile]`` bool: the blocks of each packet's
    work item ``k`` (:func:`item_blocks`; none past its last item)."""
    counts = tile_blocks(words, blocks_per_tile, granule).tolist()
    table = torch.zeros((words.shape[0], words.shape[1] * blocks_per_tile),
                        dtype=torch.bool)
    for p, row in enumerate(words.tolist()):
        table[p, item_blocks(row, counts[p], blocks_per_tile, granule, split, k)] = True
    return table.to(words.device)


def search_words_split(o, d, words, plane, orig_idx, tile: int, granule: int,
                       split: int):
    """Plain model of the kernel's split walk: a lex-min per work item of
    ``split`` blocks, the items of a ray merged only through
    :func:`~raytracingc_tpu_torch.ops.search_range.pack_keys` by a minimum,
    from :data:`MISS_KEY`, and unpacked."""
    bpt = tile // BLOCK
    items = words_items(words, bpt, granule, split)
    keys = torch.full((o.shape[0],), MISS_KEY, dtype=torch.int64, device=o.device)
    for k in range(int(items.max()) if items.numel() else 0):
        dk, ik = search_blocks_reference(
            o, d, plane, orig_idx, item_table(words, bpt, granule, split, k))
        keys = torch.minimum(keys, torch.where(ik >= 0, pack_keys(dk, ik), MISS_KEY))
    return unpack_keys(keys)


@no_tangent
def search_words(o, d, words, plane, orig_idx, tile: int, granule: int):
    """One-word-per-tile packet search: ``(dst [R], idx [R])``.

    A CPU tensor runs :func:`search_words_reference`. A CUDA tensor launches
    ``csrc/search_words.cu`` (building the library on first use) through
    ``search_range.item_search`` and counts one launch per call in
    ``search_words.launches``; any other device raises.
    """
    if words.dim() != 2:
        raise ValueError(f"words: expected [P, n_tiles], got {tuple(words.shape)}")
    check_tiled_args(o, d, words[..., None], plane, orig_idx, tile, granule)
    if o.device.type == "cpu":
        return search_words_reference(o, d, words, plane, orig_idx, tile,
                                      granule)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_words: no kernel for device {o.device}")

    out = words_search_cuda(o, d, words, plane, orig_idx, tile // BLOCK,
                            granule, 1, "search_words")
    search_words.launches += 1
    return out


def words_search_cuda(o, d, words, plane, orig_idx, blocks_per_tile: int,
                      granule: int, row_packets: int, what: str):
    """``csrc/search_words.cu`` on CUDA tensors through
    ``search_range.item_search``: packet ``p`` walks word row ``p //
    row_packets`` of ``words [rows, n_tiles]`` (``row_packets`` 1, or 128
    for the union walk) over the ``[12, n_cols]`` plane. The caller counts
    the launch."""
    r = o.shape[0]
    dims = (words.shape[1], blocks_per_tile, granule, row_packets)
    return item_search(
        o, what,
        lambda lib, items, counter, keys, stream: lib.rtc_words_items(
            words.data_ptr(), r, *dims, items.data_ptr(), counter.data_ptr(),
            keys.data_ptr(), stream),
        lambda lib, ends, counter, keys, stream: lib.rtc_search_words(
            o.data_ptr(), d.data_ptr(), words.data_ptr(), ends.data_ptr(),
            plane.data_ptr(), orig_idx.data_ptr(), r, plane.shape[1],
            *dims, counter.data_ptr(), keys.data_ptr(), stream))


search_words.launches = 0
