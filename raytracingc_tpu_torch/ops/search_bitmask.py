"""Bitmask packet search (K2): the CUDA kernel and its plain version.

Counterpart of ``raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_bitmask``
(and ``_search_tile_bitmask``). The kernel is ``csrc/search_bitmask.cu``;
:func:`search_bitmask_reference` is its plain PyTorch version, used on CPU
tensors and by the tests and ``chip_smoke.py`` to hold the kernel against.

Inputs: rays ``o, d [R, 3]`` float32; culling words ``[ceil(R / 8), W]``
int32 from ``ops/culling.py::packet_block_masks`` (bit ``j`` of word ``w``
of packet ``p`` = block ``w * 31 + j`` for rays ``8p .. 8p + 7``); the
accel's ``[12, T]`` plane and ``orig_idx [T]``. Every ray of a packet tests
the blocks of the packet's set bits and keeps the lexicographic minimum of
(dst, original index). Dead lanes are NOT masked: a dead ray in a packet
with a live lane gets its real hit, and a packet without live lanes has no
bits and misses, exactly as in the JAX package. Returns ``dst [R]`` float32
and ``idx [R]`` int32 (original order, -1 on a miss).

Both count the (packet, block) pairs they walk, the set bits below the
scene's last block, into the counter ``search.bitmask_blocks``
(``utils/profiling.py``): the plain version adds them to the host's count,
the kernel to an int64 on its card (:func:`card_blocks`), which
``profiling.counters()`` reads.
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.ops.accel import BLOCK, PAD_ORIG_IDX
from raytracingc_tpu_torch.ops.culling import BITS_PER_WORD, RAY_SUBLANES
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.ops.search_brute import mt_distance
from raytracingc_tpu_torch.scene.types import MISS_DST
from raytracingc_tpu_torch.utils.profiling import COUNTS

# (packet, block) pairs per step of the plain search: 2,048 pairs make
# [2048, 8, 128] float32 temporaries (8 MiB each).
PAIR_CHUNK = 2048


def search_blocks_reference(o, d, plane, orig_idx, tested, chunk=PAIR_CHUNK):
    """Plain packet search over an explicit ``[P, n_blocks]`` bool table.

    Packet ``p`` (rays ``8p .. 8p + 7``) runs :func:`mt_distance` against
    every triangle of each block ``b`` with ``tested[p, b]`` and keeps, per
    ray, the lexicographic minimum of (dst, original index). The minimum of
    a total order does not depend on the order the pairs are visited in, so
    this equals the kernels' ascending walk bit for bit; it visits the
    (packet, block) pairs in chunks so that its work, like the kernels', is
    that of the set bits only. The plain K2 and K3 versions both end here.
    """
    r = o.shape[0]
    n_packets = tested.shape[0]
    dev = o.device
    pad = n_packets * RAY_SUBLANES - r
    rays = [torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(-1, RAY_SUBLANES, 3)
            for x in (o, d)]
    best_d = torch.full((n_packets * RAY_SUBLANES,), MISS_DST,
                        dtype=torch.float32, device=dev)
    best_i = torch.full_like(best_d, PAD_ORIG_IDX, dtype=torch.int32)
    big = torch.full((), PAD_ORIG_IDX, dtype=torch.int32, device=dev)
    pk, blk = torch.nonzero(tested, as_tuple=True)
    lanes = torch.arange(RAY_SUBLANES, device=dev)
    cols = torch.arange(BLOCK, device=dev)
    for s in range(0, pk.numel(), chunk):
        p, b = pk[s:s + chunk], blk[s:s + chunk]
        tri_cols = b[:, None] * BLOCK + cols  # [n, 128]
        rp = [x[p][:, :, None, :] for x in rays]  # [n, 8, 1, 3]
        ray = tuple(x[..., k] for x in rp for k in range(3))
        tri = plane[:, tri_cols][:, :, None, :]  # [12, n, 1, 128]
        dst = mt_distance(ray, tri)  # [n, 8, 128]
        oi = orig_idx[tri_cols][:, None, :]  # [n, 1, 128]
        dmin = dst.amin(dim=2)  # [n, 8]
        imin = torch.where(dst == dmin[:, :, None], oi, big).amin(dim=2)
        rid = (p[:, None] * RAY_SUBLANES + lanes).reshape(-1)
        best_d, best_i = lex_merge(best_d, best_i, rid, dmin.reshape(-1),
                                   imin.reshape(-1), big)
    best_d, best_i = best_d[:r], best_i[:r]
    return best_d, torch.where(best_d < MISS_DST, best_i, -1)


def lex_merge(best_d, best_i, rid, dmin, imin, big):
    """Merge candidates ``(dmin, imin)`` of rays ``rid`` (repeats allowed)
    into the running best: the new minimum distance first, then the lowest
    index among the entries that reach it. ``big`` is the int32 index that
    loses every tie."""
    new_d = best_d.scatter_reduce(0, rid, dmin, "amin")
    cand = torch.where(dmin == new_d[rid], imin, big)
    keep = torch.where(best_d == new_d, best_i, big)
    return new_d, keep.scatter_reduce(0, rid, cand, "amin")


def bitmask_table(words, n_blocks: int):
    """``[P, W]`` words → ``[P, n_blocks]`` bool: block ``w * 31 + j`` is
    tested iff bit ``j`` of word ``w`` is set (bits past ``n_blocks`` are
    ignored, as the kernel ignores them)."""
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).bool()
    return bits.flatten(1)[:, :n_blocks]


def search_bitmask_reference(o, d, words, plane, orig_idx):
    """Plain PyTorch version of the bitmask kernel (same inputs, same bits,
    the same pairs counted)."""
    table = bitmask_table(words, plane.shape[1] // BLOCK)
    COUNTS["search.bitmask_blocks"] += int(table.sum())
    return search_blocks_reference(o, d, plane, orig_idx, table)


# The kernel's counts of walked (packet, block) pairs: one int64 [1] tensor
# per card index, made on the card's first launch.
_card_blocks: dict = {}


def card_blocks() -> int:
    """The (packet, block) pairs the kernel has walked on every card, read
    from the cards (a sync of each)."""
    return sum(int(t.item()) for t in _card_blocks.values())


def check_packet_args(o, d, plane, orig_idx, tables):
    """Validate the packet kernels' inputs (dtypes, shapes, contiguity,
    one device); raise ``ValueError`` on what the kernels do not take.
    ``tables``: ``{name: (tensor, shape)}``, the int32 culling tables."""
    want = (
        ("o", o, torch.float32, (o.shape[0], 3)),
        ("d", d, torch.float32, (o.shape[0], 3)),
        *((name, x, torch.int32, shape) for name, (x, shape) in tables.items()),
        ("plane", plane, torch.float32, (12, plane.shape[1])),
        ("orig_idx", orig_idx, torch.int32, (plane.shape[1],)),
    )
    for name, x, dtype, shape in want:
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
    if plane.shape[1] % BLOCK:
        raise ValueError(f"plane: {plane.shape[1]} triangles, not a multiple "
                         f"of {BLOCK}")
    if o.shape[0] >= 2**31 - BLOCK:
        raise ValueError(f"{o.shape[0]} rays: the kernels index rays in int32")


def n_packets(n_rays: int) -> int:
    return -(-n_rays // RAY_SUBLANES)


@no_tangent
def search_bitmask(o, d, words, plane, orig_idx):
    """Bitmask packet search: ``(dst [R], idx [R])``.

    A CPU tensor runs :func:`search_bitmask_reference`. A CUDA tensor
    launches ``csrc/search_bitmask.cu`` (building the library on first use,
    and the card's block counter on its first launch there) and counts the
    launch in ``search_bitmask.launches``; any other device raises.
    """
    r = o.shape[0]
    check_packet_args(o, d, plane, orig_idx,
                      {"words": (words, (n_packets(r), words.shape[-1]))})
    if o.device.type == "cpu":
        return search_bitmask_reference(o, d, words, plane, orig_idx)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_bitmask: no kernel for device {o.device}")

    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    blocks = _card_blocks.get(o.device.index)
    if blocks is None:
        blocks = _card_blocks[o.device.index] = torch.zeros(
            (1,), dtype=torch.int64, device=o.device)
    with _build.card(o.device) as (lib, stream):
        code = lib.rtc_search_bitmask(
            o.data_ptr(), d.data_ptr(), words.data_ptr(), plane.data_ptr(),
            orig_idx.data_ptr(), r, words.shape[1], plane.shape[1] // BLOCK,
            dst.data_ptr(), idx.data_ptr(), blocks.data_ptr(), stream,
        )
    _build.check(code, "search_bitmask launch")
    search_bitmask.launches += 1
    return dst, idx


search_bitmask.launches = 0
