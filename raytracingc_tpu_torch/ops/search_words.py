"""One-word-per-tile packet search (K6, K7): the CUDA kernel and its plain
version.

Counterpart of
``raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_streamed_words``
(ray-major grid; also the resident words route, one tile of the whole
plane) and of ``_search_kernel_streamed_words_tmajor`` (tile-major grid,
with the cross-tile lex-min fold of its launcher). The two differ only in
grid order, which has no meaning on the card, so ``csrc/search_words.cu``
serves both (``RTC_STREAM_ORDER`` picks nothing here).
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
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.search_bitmask import search_blocks_reference
from raytracingc_tpu_torch.ops.search_packed import check_tiled_args, packed_table


def search_words_reference(o, d, words, plane, orig_idx, tile: int,
                           granule: int):
    """Plain PyTorch version of the words kernel (same inputs, same bits)."""
    table = packed_table(words[..., None], tile // BLOCK, granule)
    return search_blocks_reference(o, d, plane, orig_idx, table)


def search_words(o, d, words, plane, orig_idx, tile: int, granule: int):
    """One-word-per-tile packet search: ``(dst [R], idx [R])``.

    A CPU tensor runs :func:`search_words_reference`. A CUDA tensor launches
    ``csrc/search_words.cu`` (building the library on first use) and counts
    the launch in ``search_words.launches``; any other device raises.
    """
    if words.dim() != 2:
        raise ValueError(f"words: expected [P, n_tiles], got {tuple(words.shape)}")
    check_tiled_args(o, d, words[..., None], plane, orig_idx, tile, granule)
    if o.device.type == "cpu":
        return search_words_reference(o, d, words, plane, orig_idx, tile,
                                      granule)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_words: no kernel for device {o.device}")

    import ctypes

    from raytracingc_tpu_torch.ops import _build

    lib = _build.load_library()
    r = o.shape[0]
    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        code = lib.rtc_search_words(
            o.data_ptr(), d.data_ptr(), words.data_ptr(), plane.data_ptr(),
            orig_idx.data_ptr(), ctypes.c_int(r), ctypes.c_int(words.shape[1]),
            ctypes.c_int(tile // BLOCK), ctypes.c_int(granule),
            dst.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(code, "search_words launch")
    search_words.launches += 1
    return dst, idx


search_words.launches = 0
