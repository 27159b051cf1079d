"""Range packet search (K4, K5): the CUDA kernel and its plain version.

Counterpart of ``raytracingc_tpu/ops/intersect_pallas.py::_search_kernel``
(the resident range kernel, with ``_search_tile``) and of
``_search_kernel_streamed`` (the same over triangle tiles, with its
cross-tile lex merge). One kernel serves both: the span table holds global
block ids and does not depend on tiling (see the header of
``csrc/search_range.cu``). :func:`search_range_reference` is its plain
PyTorch version, used on CPU tensors and by the tests and ``chip_smoke.py``
to hold the kernel against.

Inputs: rays ``o, d [R, 3]`` float32; the spans ``first, last
[ceil(R / 8)]`` int32 from ``ops/culling.py::packet_block_ranges`` (packet
``p`` = rays ``8p .. 8p + 7``; an empty span is ``first = 2**30, last =
-1``); the accel's ``[12, T]`` plane and ``orig_idx [T]``, padded to whole
tiles for the streamed route (``culling.stream_tile_pad``). Every ray of a
packet tests the blocks ``b`` of the plane with ``first <= b <= last`` and
keeps the lexicographic minimum of (dst, original index); dead lanes are
not masked (see ``search_bitmask``). Returns ``dst [R]`` float32 and ``idx
[R]`` int32 (-1 on a miss).
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.search_bitmask import (
    check_packet_args,
    n_packets,
    search_blocks_reference,
)


def range_table(first, last, n_blocks: int):
    """``[P]`` spans → ``[P, n_blocks]`` bool: block ``b`` is tested iff
    ``first <= b <= last`` (blocks past the plane are never tested)."""
    b = torch.arange(n_blocks, dtype=torch.int32, device=first.device)
    return (first[:, None] <= b) & (b <= last[:, None])


def search_range_reference(o, d, first, last, plane, orig_idx):
    """Plain PyTorch version of the range kernel (same inputs, same bits)."""
    table = range_table(first, last, plane.shape[1] // BLOCK)
    return search_blocks_reference(o, d, plane, orig_idx, table)


def search_range(o, d, first, last, plane, orig_idx):
    """Range packet search: ``(dst [R], idx [R])``.

    A CPU tensor runs :func:`search_range_reference`. A CUDA tensor launches
    ``csrc/search_range.cu`` (building the library on first use) and counts
    the launch in ``search_range.launches``; any other device raises.
    """
    r = o.shape[0]
    shape = (n_packets(r),)
    check_packet_args(o, d, plane, orig_idx,
                      {"first": (first, shape), "last": (last, shape)})
    if o.device.type == "cpu":
        return search_range_reference(o, d, first, last, plane, orig_idx)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_range: no kernel for device {o.device}")

    import ctypes

    from raytracingc_tpu_torch.ops import _build

    lib = _build.load_library()
    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        code = lib.rtc_search_range(
            o.data_ptr(), d.data_ptr(), first.data_ptr(), last.data_ptr(),
            plane.data_ptr(), orig_idx.data_ptr(), ctypes.c_int(r),
            ctypes.c_int(plane.shape[1] // BLOCK),
            dst.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(code, "search_range launch")
    search_range.launches += 1
    return dst, idx


search_range.launches = 0
