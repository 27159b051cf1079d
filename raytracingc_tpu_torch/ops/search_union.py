"""Union-walk search (K9): the CUDA kernel and its plain version.

Counterpart of ``tools/union_walk_ab.py::_union_kernel`` (launcher
``_search_padded_union``), the JAX package's A/B prototype of program-level
culling with the brute kernel's scalar Möller–Trumbore: every ray of a
1,024-ray program tests every triangle of each block set in its program's
union word (``ops/culling.py::program_union_words``, the words the MXU
kernel walks). The kernel is ``csrc/search_union.cu`` (``rtc::mt_block`` of
``csrc/mt.cuh``); :func:`search_union_reference` is its plain PyTorch
version, :func:`ops.search_bitmask.search_blocks_reference` with each packet
given its program's union. Results are bit for bit those of every other
search kernel on live lanes. Dead lanes are not masked (the tool masks
them, as the JAX tool does). Returns ``dst [R]`` float32 and ``idx [R]``
int32 (original order, -1 on a miss).
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.culling import PACKETS_PER_PROGRAM, RAYS_PER_PROGRAM
from raytracingc_tpu_torch.ops.search_bitmask import (
    bitmask_table,
    check_packet_args,
    n_packets,
    search_blocks_reference,
)


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


def search_union(o, d, words, flags, plane, orig_idx):
    """Union-walk search: ``(dst [R], idx [R])``.

    ``words [G, W]`` and ``flags [G]`` int32 (``G = ceil(R / 1024)``), the
    accel's ``[12, T]`` plane and ``orig_idx [T]``. A CPU tensor runs
    :func:`search_union_reference`. A CUDA tensor launches
    ``csrc/search_union.cu`` (building the library on first use) and counts
    the launch in ``search_union.launches``; any other device raises.
    """
    r = o.shape[0]
    g = -(-r // RAYS_PER_PROGRAM)
    check_packet_args(o, d, plane, orig_idx, {
        "words": (words, (g, words.shape[-1])), "flags": (flags, (g,))})
    if o.device.type == "cpu":
        return search_union_reference(o, d, words, flags, plane, orig_idx)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_union: no kernel for device {o.device}")

    import ctypes

    from raytracingc_tpu_torch.ops import _build

    lib = _build.load_library()
    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        code = lib.rtc_search_union(
            o.data_ptr(), d.data_ptr(), words.data_ptr(), flags.data_ptr(),
            plane.data_ptr(), orig_idx.data_ptr(), ctypes.c_int(r),
            ctypes.c_int(words.shape[1]), ctypes.c_int(plane.shape[1] // BLOCK),
            dst.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(code, "search_union launch")
    search_union.launches += 1
    return dst, idx


search_union.launches = 0
