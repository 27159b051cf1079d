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

The kernel cuts each packet's clipped span into work items of at most
``kSplit`` = :data:`SPLIT` blocks, walks each item in one warp and merges
the items of a ray through a 64-bit key, ``bits(dst) << 32 | orig_idx``
(:func:`pack_keys`), with ``atomicMin``. :func:`range_items` and
:func:`search_range_split` are the plain model of that work list and split
walk at any split: the tests hold the model to :func:`search_range_reference`.
:func:`item_search` is the launch sequence that the range and words
wrappers share: the count kernel (which also fills the keys with
:data:`MISS_KEY` and zeroes the claim counter), a ``torch.cumsum`` of the
counts, the search, and :func:`unpack_keys_cuda`, the CUDA unpack whose
plain version is :func:`unpack_keys`.
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.ops.accel import BLOCK, PAD_ORIG_IDX
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.ops.search_bitmask import (
    check_packet_args,
    n_packets,
    search_blocks_reference,
)
from raytracingc_tpu_torch.scene.types import MISS_DST

SPLIT = 16  # kSplit of csrc/search_range.cu: blocks per work item


def range_table(first, last, n_blocks: int):
    """``[P]`` spans → ``[P, n_blocks]`` bool: block ``b`` is tested iff
    ``first <= b <= last`` (blocks past the plane are never tested)."""
    b = torch.arange(n_blocks, dtype=torch.int32, device=first.device)
    return (first[:, None] <= b) & (b <= last[:, None])


def search_range_reference(o, d, first, last, plane, orig_idx):
    """Plain PyTorch version of the range kernel (same inputs, same bits)."""
    table = range_table(first, last, plane.shape[1] // BLOCK)
    return search_blocks_reference(o, d, plane, orig_idx, table)


def pack_keys(dst, idx):
    """``(dst, idx)`` → int64 keys ``bits(dst) << 32 | idx`` that order
    exactly like (dst, idx) lexicographically, for float32 ``dst >= 0`` (the
    kernels' distances are ``>= EPSILON`` or ``MISS_DST``) and int32 ``0 <=
    idx <= 2**30``."""
    return (dst.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def unpack_keys(keys):
    """int64 keys → ``(dst, idx)``, ``idx = -1`` where ``dst == MISS_DST``:
    the wrapper's output."""
    dst = (keys >> 32).to(torch.int32).view(torch.float32)
    idx = (keys & 0xFFFFFFFF).to(torch.int32)
    return dst, torch.where(dst < MISS_DST, idx, -1)


# The key every ray starts from: a miss that loses every tie.
MISS_KEY = int(pack_keys(torch.tensor(MISS_DST, dtype=torch.float32),
                         torch.tensor(PAD_ORIG_IDX, dtype=torch.int32)))


def range_items(first, last, n_blocks: int, split: int):
    """Work items per packet, ``[P]`` int32: ``ceil(blocks / split)`` of the
    span clipped to ``[0, n_blocks)``, 0 when it is empty. The plain version
    of ``csrc/search_range.cu::range_items_kernel`` (``split = kSplit``)."""
    lo = first.clamp(min=0)
    hi = last.clamp(max=n_blocks - 1)
    return ((hi - lo).div(split, rounding_mode="floor") + 1).clamp(min=0).to(torch.int32)


def item_table(first, last, n_blocks: int, split: int, k: int):
    """``[P, n_blocks]`` bool: the blocks of each packet's work item ``k``,
    ``lo + k * split .. min(lo + k * split + split - 1, hi)`` of its clipped
    span ``[lo, hi]`` (none past its last item)."""
    start = first.clamp(min=0) + k * split
    end = torch.minimum(last.clamp(max=n_blocks - 1), start + split - 1)
    return range_table(start, end, n_blocks)


def search_range_split(o, d, first, last, plane, orig_idx, split: int):
    """Plain model of the kernel's split walk: a lex-min per work item of
    ``split`` blocks, the items of a ray merged only through
    :func:`pack_keys` by a minimum, from :data:`MISS_KEY`, and unpacked."""
    n_blocks = plane.shape[1] // BLOCK
    items = range_items(first, last, n_blocks, split)
    keys = torch.full((o.shape[0],), MISS_KEY, dtype=torch.int64, device=o.device)
    for k in range(int(items.max()) if items.numel() else 0):
        dk, ik = search_blocks_reference(
            o, d, plane, orig_idx, item_table(first, last, n_blocks, split, k))
        keys = torch.minimum(keys, torch.where(ik >= 0, pack_keys(dk, ik), MISS_KEY))
    return unpack_keys(keys)


@no_tangent
def search_range(o, d, first, last, plane, orig_idx):
    """Range packet search: ``(dst [R], idx [R])``.

    A CPU tensor runs :func:`search_range_reference`. A CUDA tensor launches
    ``csrc/search_range.cu`` (building the library on first use) through
    :func:`item_search` and counts one launch per call in
    ``search_range.launches``; any other device raises.
    """
    r = o.shape[0]
    shape = (n_packets(r),)
    check_packet_args(o, d, plane, orig_idx,
                      {"first": (first, shape), "last": (last, shape)})
    if o.device.type == "cpu":
        return search_range_reference(o, d, first, last, plane, orig_idx)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_range: no kernel for device {o.device}")

    n_blocks = plane.shape[1] // BLOCK
    out = item_search(
        o, "search_range",
        lambda lib, items, counter, keys, stream: lib.rtc_range_items(
            first.data_ptr(), last.data_ptr(), r, n_blocks,
            items.data_ptr(), counter.data_ptr(), keys.data_ptr(), stream),
        lambda lib, ends, counter, keys, stream: lib.rtc_search_range(
            o.data_ptr(), d.data_ptr(), first.data_ptr(), last.data_ptr(),
            ends.data_ptr(), plane.data_ptr(), orig_idx.data_ptr(),
            r, n_blocks, counter.data_ptr(), keys.data_ptr(), stream))
    search_range.launches += 1
    return out


search_range.launches = 0


def item_search(o, what: str, count, search):
    """The CUDA launch sequence of the range and words searches on ``o``'s
    card: ``count(lib, items, counter, keys, stream)`` launches the count
    kernel, which writes each packet's item count into ``items`` and fills
    ``keys`` with :data:`MISS_KEY` and ``counter`` with 0; ``ends``, the
    counts' ``torch.cumsum`` (on the device: no host sync); ``search(lib,
    ends, counter, keys, stream)`` launches the search; the keys go through
    the CUDA unpack of :func:`unpack_keys_cuda`. Returns ``(dst, idx)``."""
    r = o.shape[0]
    items = torch.empty((n_packets(r),), dtype=torch.int32, device=o.device)
    state = torch.empty((r + 1,), dtype=torch.int64, device=o.device)
    counter, keys = state[:1], state[1:]
    with _build.card(o.device) as (lib, stream):
        _build.check(count(lib, items, counter, keys, stream), f"{what} items launch")
        ends = torch.cumsum(items, 0, dtype=torch.int64)
        _build.check(search(lib, ends, counter, keys, stream), f"{what} launch")
        return _unpack(lib, keys, None, stream)


def _unpack(lib, keys, alive, stream):
    n = keys.shape[0]
    dst = torch.empty((n,), dtype=torch.float32, device=keys.device)
    idx = torch.empty((n,), dtype=torch.int32, device=keys.device)
    _build.check(lib.rtc_unpack_keys(
        keys.data_ptr(), None if alive is None else alive.data_ptr(),
        n, dst.data_ptr(), idx.data_ptr(), stream), "unpack_keys launch")
    return dst, idx


def unpack_keys_cuda(keys, alive=None):
    """:func:`unpack_keys` of int64 CUDA ``keys`` by ``csrc/search_range.cu``'s
    unpack kernel (one launch): ``(dst, idx)``, the same bits; where
    ``alive`` (bool, optional) is False, ``(MISS_DST, -1)``, as the MXU
    search's unpack gives its dead lanes."""
    with _build.card(keys.device) as (lib, stream):
        return _unpack(lib, keys, alive, stream)


def search_grid(device, kernel: str) -> tuple[int, int]:
    """``(resident CTAs per SM, SMs)`` of the persistent grid of the
    ``kernel="range"`` or ``"words"`` search on a CUDA ``device``."""
    import ctypes

    ctas, sms = ctypes.c_int(), ctypes.c_int()
    with _build.card(device) as (lib, _):
        _build.check(getattr(lib, f"rtc_search_{kernel}_grid")(
            ctypes.byref(ctas), ctypes.byref(sms)), f"search_{kernel} grid")
    return ctas.value, sms.value
