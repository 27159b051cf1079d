"""Union-walk search (K9): the CUDA kernel and its plain version.

Counterpart of ``tools/union_walk_ab.py::_union_kernel`` (launcher
``_search_padded_union``), the JAX package's A/B prototype of program-level
culling with the brute kernel's scalar Möller–Trumbore: every ray of a
1,024-ray program, dead lanes included, tests every triangle of each block
set in its program's union word (``ops/culling.py::program_union_words``,
the words the MXU kernel walks); a program whose flag is 0 misses.
:func:`search_union_reference` is its plain PyTorch version,
:func:`ops.search_bitmask.search_blocks_reference` with each packet given
its program's union. Results are bit for bit those of every other search
kernel on live lanes. Dead lanes are not masked (the tool masks them, as
the JAX tool does). Returns ``dst [R]`` float32 and ``idx [R]`` int32
(original order, -1 on a miss).

The kernel is the words kernel (``csrc/search_words.cu``, K6/K7) with one
word row per program: packet ``p`` walks row ``p // 128``, the program's
union read as ``W`` tiles of 31 blocks at granule 1 (:func:`union_rows`),
one warp per 8-ray packet over ``packet_walk.cuh``, the walk cut into work
items merged through 64-bit keys. What bounds it on an H100 is the MT work:
61 FP32 operations per (ray, triangle) pair, for every union block and all
1,024 rays of a program (more pairs than a packet's own bits: the pair
inflation that chip_smoke.py counts). :func:`union_rows` and
:func:`search_union_words` give the same search as
:func:`ops.search_words.search_words_reference` on the rows each packet
reads, which the tests hold bit for bit to :func:`search_union_reference`.
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.culling import (
    BITS_PER_WORD,
    PACKETS_PER_PROGRAM,
    RAYS_PER_PROGRAM,
    stream_tile_pad,
)
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.ops.search_bitmask import (
    bitmask_table,
    check_packet_args,
    n_packets,
    search_blocks_reference,
)
from raytracingc_tpu_torch.ops.search_words import search_words_reference, words_search_cuda

# The union row as the words kernel reads it: W tiles of 31 blocks, one bit
# a block.
UNION_TILE = BITS_PER_WORD * BLOCK


def union_table(words, flags, n_rays: int, n_blocks: int):
    """Program words ``[G, W]`` and flags ``[G]`` → the ``[P, n_blocks]``
    bool table of the packets (``P = ceil(R / 8)``): each packet tests its
    program's union."""
    table = bitmask_table(words, n_blocks) & (flags != 0)[:, None]
    return table.repeat_interleave(PACKETS_PER_PROGRAM, dim=0)[:n_packets(n_rays)]


def search_union_reference(o, d, words, flags, plane, orig_idx):
    """Plain PyTorch version of the union-walk kernel (same inputs, same bits)."""
    table = union_table(words, flags, o.shape[0], plane.shape[1] // BLOCK)
    return search_blocks_reference(o, d, plane, orig_idx, table)


def union_rows(words, flags, n_blocks: int):
    """The word rows the kernel walks: ``words`` with the bits past block
    ``n_blocks - 1`` (and bit 31) cleared, and the rows of programs whose
    flag is 0 cleared."""
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32, device=words.device)
    real = torch.arange(words.shape[1] * BITS_PER_WORD, device=words.device).reshape(
        -1, BITS_PER_WORD) < n_blocks
    mask = (real.to(torch.int32) << shifts).sum(1, dtype=torch.int32)
    return torch.where(flags[:, None] != 0, words & mask, 0)


def search_union_words(o, d, words, flags, plane, orig_idx):
    """The union walk as the words search computes it: each packet's row of
    :func:`union_rows` (its program's) as ``W`` tiles of 31 blocks at
    granule 1, over the plane padded to whole tiles
    (``culling.stream_tile_pad``); the plain words version."""
    rows = union_rows(words, flags, plane.shape[1] // BLOCK)
    rows = rows.repeat_interleave(PACKETS_PER_PROGRAM, dim=0)[:n_packets(o.shape[0])]
    plane, oi = stream_tile_pad(plane, orig_idx, UNION_TILE)
    return search_words_reference(o, d, rows, plane, oi, UNION_TILE, 1)


@no_tangent
def search_union(o, d, words, flags, plane, orig_idx):
    """Union-walk search: ``(dst [R], idx [R])``.

    ``words [G, W]`` and ``flags [G]`` int32 (``G = ceil(R / 1024)``), the
    accel's ``[12, T]`` plane and ``orig_idx [T]``. A CPU tensor runs
    :func:`search_union_reference`. A CUDA tensor launches the words kernel
    of ``csrc/search_words.cu`` with one row per program (building the
    library on first use) and counts the launch in
    ``search_union.launches``; any other device raises.
    """
    r = o.shape[0]
    g = -(-r // RAYS_PER_PROGRAM)
    check_packet_args(o, d, plane, orig_idx, {
        "words": (words, (g, words.shape[-1])), "flags": (flags, (g,))})
    if o.device.type == "cpu":
        return search_union_reference(o, d, words, flags, plane, orig_idx)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_union: no kernel for device {o.device}")
    out = words_search_cuda(o, d, union_rows(words, flags, plane.shape[1] // BLOCK),
                            plane, orig_idx, BITS_PER_WORD, 1, PACKETS_PER_PROGRAM,
                            "search_union")
    search_union.launches += 1
    return out


search_union.launches = 0
