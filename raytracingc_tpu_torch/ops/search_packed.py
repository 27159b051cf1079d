"""Packed multi-word packet search over tiles (K3): the CUDA kernel and its
plain version.

Counterpart of
``raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_streamed_packed_tmajor``
with the cross-tile lex-min fold of its launcher. The kernel is
``csrc/search_packed.cu``; :func:`search_packed_reference` is its plain
PyTorch version, used on CPU tensors and by the tests and ``chip_smoke.py``
to hold the kernel against.

Inputs: rays ``o, d [R, 3]`` float32; culling words ``[ceil(R / 8),
n_tiles, W]`` int32 from ``ops/culling.py::packet_tile_words_multi``; the
``[12, n_tiles * tile]`` plane and ``orig_idx`` padded to whole tiles
(``culling.stream_tile_pad``); the tile size and the culling ``granule``.
Bit ``j`` of word ``w`` of tile ``t`` covers the tile-local blocks
``[(w * 31 + j) * granule, ... + granule)`` clipped to the tile. Each ray
keeps the lexicographic minimum of (dst, original index) over the blocks of
its packet's set bits; dead lanes are not masked (see ``search_bitmask``).
Returns ``dst [R]`` float32 and ``idx [R]`` int32 (-1 on a miss).
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.culling import BITS_PER_WORD
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.ops.search_bitmask import (
    check_packet_args,
    n_packets,
    search_blocks_reference,
)


def packed_table(words, blocks_per_tile: int, granule: int):
    """``[P, n_tiles, W]`` words → ``[P, n_tiles * blocks_per_tile]`` bool:
    each set bit expanded to the blocks of its granule, clipped to its
    tile."""
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32, device=words.device)
    bits = ((words[..., None] >> shifts) & 1).bool().flatten(2)  # [P, n_tiles, W * 31]
    blocks = bits.repeat_interleave(granule, dim=2)[:, :, :blocks_per_tile]
    return blocks.flatten(1)


def search_packed_reference(o, d, words, plane, orig_idx, tile: int,
                            granule: int):
    """Plain PyTorch version of the packed kernel (same inputs, same bits)."""
    table = packed_table(words, tile // BLOCK, granule)
    return search_blocks_reference(o, d, plane, orig_idx, table)


def check_tiled_args(o, d, words, plane, orig_idx, tile, granule):
    """Validate the tiled kernels' inputs (``words [P, n_tiles, W]``)."""
    if words.dim() != 3:
        raise ValueError(f"words: expected [P, n_tiles, W], got {tuple(words.shape)}")
    check_packet_args(o, d, plane, orig_idx,
                      {"words": (words, (n_packets(o.shape[0]), *words.shape[1:]))})
    if tile < BLOCK or tile % BLOCK or plane.shape[1] != words.shape[1] * tile:
        raise ValueError(
            f"tile={tile}: expected a multiple of {BLOCK} with plane width "
            f"{plane.shape[1]} = n_tiles {words.shape[1]} x tile")
    bpt = tile // BLOCK
    if not 1 <= granule <= bpt:
        raise ValueError(f"granule={granule}: expected an integer in [1, {bpt}]")
    if words.shape[2] * BITS_PER_WORD * granule < bpt:
        raise ValueError(f"words: {words.shape[2]} words per tile cannot cover "
                         f"{bpt} blocks at granule {granule}")


@no_tangent
def search_packed(o, d, words, plane, orig_idx, tile: int, granule: int):
    """Packed packet search over tiles: ``(dst [R], idx [R])``.

    A CPU tensor runs :func:`search_packed_reference`. A CUDA tensor
    launches ``csrc/search_packed.cu`` (building the library on first use)
    and counts the launch in ``search_packed.launches``; any other device
    raises.
    """
    check_tiled_args(o, d, words, plane, orig_idx, tile, granule)
    if o.device.type == "cpu":
        return search_packed_reference(o, d, words, plane, orig_idx, tile,
                                       granule)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_packed: no kernel for device {o.device}")

    r = o.shape[0]
    _, n_tiles, n_words = words.shape
    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    with _build.card(o.device) as (lib, stream):
        code = lib.rtc_search_packed(
            o.data_ptr(), d.data_ptr(), words.data_ptr(), plane.data_ptr(),
            orig_idx.data_ptr(), r, n_tiles, n_words, tile // BLOCK, granule,
            dst.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(code, "search_packed launch")
    search_packed.launches += 1
    return dst, idx


search_packed.launches = 0
