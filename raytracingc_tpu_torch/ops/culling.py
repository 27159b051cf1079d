"""Culling preludes of the packet kernels: per-packet hit-bit words.

Counterpart of the XLA-side preludes in
``raytracingc_tpu/ops/intersect_pallas.py`` (``_slab_any_hit``,
``packet_block_masks``, ``packet_block_ranges``, ``packet_tile_words``,
``packet_tile_words_multi``, ``stream_words_per_pair``, ``_stream_granule``,
``_stream_tile_pad``, and the MXU launcher's per-program OR of the packet
words), as plain PyTorch ops on the rays' device. Rays are
grouped in packets of :data:`RAY_SUBLANES` (ray ``r`` is in packet
``r // 8``); a bit is set (or a block falls inside a packet's span) iff
some live lane of the packet passes the slab test of a block's (or a
granule's union) AABB. The results are integers computed with the JAX
package's op order, so they equal its own bit for bit.

Memory: a slab test of C packets against G boxes makes ``(C, 8, G, 3)``
float32 temporaries, so the boxes are tested in word groups sized to
:data:`SLAB_ELEMS_BUDGET` elements (the JAX package bounds the same with
``lax.map`` over words or tiles).
"""

from __future__ import annotations

import os

import torch

from raytracingc_tpu_torch.ops.accel import PAD_ORIG_IDX, TriangleAccel

RAY_SUBLANES = 8  # rays per culling packet
BITS_PER_WORD = 31  # bit 31 is never set: the words stay non-negative int32
# Triangles per streamed tile, the packed kernel's tile above
# STREAM_MAX_RESIDENT_T (RTC_STREAM_TILE overrides).
STREAM_TILE = 16384
# Largest padded triangle count searched as ONE resident tile
# (RTC_STREAM_MAX_T overrides).
STREAM_MAX_RESIDENT_T = 65536
# The TPU kernel's scalar-memory budget for its culling tables, in int32
# words. It is a TPU-measured value that only :func:`stream_granule` still
# reads, to pick the same culling granule as the JAX package (so the words,
# and the blocks tested, are the same); the CUDA kernels read the words from
# global memory and need no such budget.
SMEM_WORDS_BUDGET = 196608
# Packets per program: the TPU kernels' grid step of 8 x 128 rays, read by
# stream_granule, and the MXU and union-walk kernels' culling unit.
PACKETS_PER_PROGRAM = 128
RAYS_PER_PROGRAM = RAY_SUBLANES * PACKETS_PER_PROGRAM
# Float32 elements per slab-test temporary (64 MiB).
SLAB_ELEMS_BUDGET = 1 << 24
_BOX_BIG = 3.0e38  # padding box bound: an inverted box, masked as invalid
EMPTY_FIRST = 2**30  # `first` of an empty block span (its `last` is -1)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def packets(o, d, alive=None):
    """Rays ``[R, 3]`` → packets ``o_p, d_p [P, 8, 3]`` and live mask
    ``a_p [P, 8]`` (``P = ceil(R / 8)``). Padding lanes are zero rays and
    dead, as in the JAX launcher, so they set no bit."""
    r = o.shape[0]
    pad = round_up(r, RAY_SUBLANES) - r
    live = (torch.ones((r,), dtype=torch.bool, device=o.device)
            if alive is None else alive)
    o_p = torch.nn.functional.pad(o, (0, 0, 0, pad)).reshape(-1, RAY_SUBLANES, 3)
    d_p = torch.nn.functional.pad(d, (0, 0, 0, pad)).reshape(-1, RAY_SUBLANES, 3)
    a_p = torch.nn.functional.pad(live, (0, pad)).reshape(-1, RAY_SUBLANES)
    return o_p, d_p, a_p


def slab_any_hit(lo, hi, o_p, inv_p, a_p):
    """AABB slab test: does any live lane of each packet hit each box?

    ``lo/hi [G, 3]`` boxes, ``o_p [C, 8, 3]`` packet origins, ``inv_p`` the
    reciprocal directions, ``a_p [C, 8]`` live lanes → ``[C, G]`` bool.
    Inverted (``lo > hi``) boxes are masked explicitly: the min/max slab
    formulation would otherwise turn them into valid intervals.
    """
    t0 = (lo[None, None] - o_p[:, :, None]) * inv_p[:, :, None]
    t1 = (hi[None, None] - o_p[:, :, None]) * inv_p[:, :, None]
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)  # [C, 8, G]
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit_box = (tmax >= torch.maximum(tmin, tmin.new_zeros(()))) & a_p[:, :, None]
    valid = torch.all(lo <= hi, dim=-1)  # [G]
    return torch.any(hit_box, dim=1) & valid[None, :]


def _inv_dir(d_p):
    """Reciprocal directions, ``|d| < 1e-20`` replaced by 1e-20 (an axis with
    d ~ 0 gives huge slab bounds of either sign: inside-origin rays still
    pass, outside-origin rays still miss)."""
    tiny = torch.full((), 1e-20, dtype=d_p.dtype, device=d_p.device)
    return 1.0 / torch.where(d_p.abs() < 1e-20, tiny, d_p)


def _box_words(lo_w, hi_w, o_p, d_p, a_p):
    """Words of boxes grouped 31 to a word: ``lo_w/hi_w [N, 31, 3]`` →
    ``[C, N]`` int32, bit ``j`` of word ``n`` set iff box ``(n, j)`` passes
    for some live lane. Tested in groups of words to bound memory."""
    inv_p = _inv_dir(d_p)
    c, n = o_p.shape[0], lo_w.shape[0]
    bits = torch.ones((), dtype=torch.int32, device=o_p.device) << torch.arange(
        BITS_PER_WORD, dtype=torch.int32, device=o_p.device)
    zero = torch.zeros((), dtype=torch.int32, device=o_p.device)
    per_word = c * RAY_SUBLANES * BITS_PER_WORD * 3
    step = max(1, SLAB_ELEMS_BUDGET // max(per_word, 1))
    out = [torch.zeros((c, 0), dtype=torch.int32, device=o_p.device)]
    for w0 in range(0, n, step):
        lo = lo_w[w0:w0 + step].reshape(-1, 3)
        hi = hi_w[w0:w0 + step].reshape(-1, 3)
        hit = slab_any_hit(lo, hi, o_p, inv_p, a_p).reshape(
            c, lo.shape[0] // BITS_PER_WORD, BITS_PER_WORD)
        out.append(torch.where(hit, bits, zero).sum(dim=2, dtype=torch.int32))
    return torch.cat(out, dim=1)


def _pad_boxes(lo, hi, n: int, dim: int):
    """Pad box bounds along ``dim`` to ``n`` with inverted boxes."""
    pad = [0, 0] * (lo.dim() - 1 - dim) + [0, n - lo.shape[dim]]
    return (torch.nn.functional.pad(lo, pad, value=_BOX_BIG),
            torch.nn.functional.pad(hi, pad, value=-_BOX_BIG))


def packet_block_masks(o_p, d_p, a_p, accel: TriangleAccel):
    """Per-packet hit words of the bitmask kernel: ``[C, n_words]`` int32.

    Bit ``j`` of word ``w`` is set iff block ``w * 31 + j`` passes the slab
    test for some live lane of the packet; ``n_words = ceil(n_blocks / 31)``.
    """
    n_words = -(-accel.n_blocks // BITS_PER_WORD)
    lo, hi = _pad_boxes(accel.aabb_lo, accel.aabb_hi,
                        n_words * BITS_PER_WORD, 0)
    return _box_words(lo.reshape(n_words, BITS_PER_WORD, 3),
                      hi.reshape(n_words, BITS_PER_WORD, 3), o_p, d_p, a_p)


def program_union_words(o_p, d_p, a_p, accel: TriangleAccel):
    """Per-program union words of the MXU and union-walk kernels:
    ``(words [G, n_words], flags [G])`` int32, ``G = ceil(P / 128)``.

    ``words[g]`` is the bitwise OR of :func:`packet_block_masks` over the
    128 packets (1,024 rays) of program ``g``, the missing packets of the
    last program counting as dead; ``flags[g]`` is 1 iff a word is nonzero.
    """
    masks = packet_block_masks(o_p, d_p, a_p, accel)
    pad = round_up(masks.shape[0], PACKETS_PER_PROGRAM) - masks.shape[0]
    words = torch.nn.functional.pad(masks, (0, 0, 0, pad)).reshape(
        -1, PACKETS_PER_PROGRAM, masks.shape[1])
    while words.shape[1] > 1:  # an OR tree over the packets
        half = words.shape[1] // 2
        words = words[:, :half] | words[:, half:]
    words = words[:, 0].contiguous()
    return words, (words != 0).any(dim=1).to(torch.int32)


def packet_block_ranges(o_p, d_p, a_p, accel: TriangleAccel):
    """Per-packet hitting-block span of the range kernel: ``(first [C],
    last [C])`` int32.

    ``first``/``last`` are the lowest and highest block that passes the slab
    test for some live lane of the packet; a packet that passes none has the
    empty span ``first =`` :data:`EMPTY_FIRST` (``2**30``), ``last = -1``,
    as in the JAX package. The blocks are tested in groups sized to
    :data:`SLAB_ELEMS_BUDGET`; a min or max over groups is the min or max
    over all blocks, so the grouping changes no bit.
    """
    inv_p = _inv_dir(d_p)
    c, n = o_p.shape[0], accel.n_blocks
    dev = o_p.device
    first = torch.full((c,), EMPTY_FIRST, dtype=torch.int32, device=dev)
    last = torch.full((c,), -1, dtype=torch.int32, device=dev)
    step = max(1, SLAB_ELEMS_BUDGET // max(c * RAY_SUBLANES * 3, 1))
    for b0 in range(0, n, step):
        lo, hi = accel.aabb_lo[b0:b0 + step], accel.aabb_hi[b0:b0 + step]
        hit = slab_any_hit(lo, hi, o_p, inv_p, a_p)  # [C, group]
        blk = torch.arange(b0, b0 + lo.shape[0], dtype=torch.int32, device=dev)
        first = torch.minimum(first, torch.where(hit, blk, EMPTY_FIRST).amin(dim=1))
        last = torch.maximum(last, torch.where(hit, blk, -1).amax(dim=1))
    return first, last


def packet_tile_words(o_p, d_p, a_p, accel: TriangleAccel, n_tiles: int,
                      blocks_per_tile: int, granule: int):
    """Per-(packet, tile) word of the words kernel: ``[C, n_tiles]`` int32.

    Bit ``j`` of tile ``t``'s word covers the tile-local blocks ``[j *
    granule, ... + granule)`` and is set iff some live lane passes the slab
    test of their union box. This is the one-word case of
    :func:`packet_tile_words_multi`, so ``granule`` must leave at most 31
    bits per tile (the words routes use ``ceil(blocks_per_tile / 31)``).
    """
    if -(-blocks_per_tile // granule) > BITS_PER_WORD:
        raise ValueError(
            f"granule={granule}: {blocks_per_tile} blocks per tile need more "
            f"than {BITS_PER_WORD} bits; expected granule >= "
            f"{-(-blocks_per_tile // BITS_PER_WORD)}")
    return packet_tile_words_multi(o_p, d_p, a_p, accel, n_tiles,
                                   blocks_per_tile, granule)[..., 0]


def stream_words_per_pair(blocks_per_tile: int, granule: int) -> int:
    """Words per (packet, tile) at a given culling granule."""
    bits_per_tile = -(-blocks_per_tile // granule)
    return -(-bits_per_tile // BITS_PER_WORD)


def packet_tile_words_multi(o_p, d_p, a_p, accel: TriangleAccel,
                            n_tiles: int, blocks_per_tile: int, granule: int):
    """Per-(packet, tile) words of the packed kernel: ``[C, n_tiles, W]``.

    ``W = stream_words_per_pair(blocks_per_tile, granule)``; bit ``j`` of
    word ``w`` of tile ``t`` covers the tile-local blocks
    ``[(w * 31 + j) * granule, ... + granule)`` and is set iff some live
    lane passes the slab test of their union box. Granule 1 is exact
    per-block culling; at any granule the set is a superset of the hit
    blocks, so the search result is the same.
    """
    bits_per_tile = -(-blocks_per_tile // granule)
    n_words = -(-bits_per_tile // BITS_PER_WORD)
    lo, hi = _pad_boxes(accel.aabb_lo, accel.aabb_hi,
                        n_tiles * blocks_per_tile, 0)
    lo = lo.reshape(n_tiles, blocks_per_tile, 3)
    hi = hi.reshape(n_tiles, blocks_per_tile, 3)
    # Tile-local granule groups (never straddling tiles), their union boxes,
    # then word groups padded to W * 31 bits.
    lo, hi = _pad_boxes(lo, hi, bits_per_tile * granule, 1)
    lo = lo.reshape(n_tiles, bits_per_tile, granule, 3).amin(dim=2)
    hi = hi.reshape(n_tiles, bits_per_tile, granule, 3).amax(dim=2)
    lo, hi = _pad_boxes(lo, hi, n_words * BITS_PER_WORD, 1)
    words = _box_words(lo.reshape(n_tiles * n_words, BITS_PER_WORD, 3),
                       hi.reshape(n_tiles * n_words, BITS_PER_WORD, 3),
                       o_p, d_p, a_p)
    return words.reshape(-1, n_tiles, n_words)


def granule_env() -> int | None:
    """``RTC_STREAM_GRANULE``: ``None`` for ``auto``, else an int >= 1."""
    env = os.environ.get("RTC_STREAM_GRANULE", "auto")
    if env == "auto":
        return None
    try:
        g = int(env)
    except ValueError:
        raise ValueError(
            f"RTC_STREAM_GRANULE={env!r}: expected 'auto' or an integer >= 1"
        ) from None
    if g < 1:
        raise ValueError(f"RTC_STREAM_GRANULE={env!r}: expected an integer >= 1")
    return g


def stream_granule(blocks_per_tile: int, n_tiles: int) -> int:
    """Culling granule of the packed kernel (``RTC_STREAM_GRANULE``).

    ``auto`` takes the JAX package's rule: the finest granule whose culling
    tables leave room for >= 4,096 rays per TPU kernel call under
    :data:`SMEM_WORDS_BUDGET`, else the one-word granule ``ceil(bpt / 31)``.
    An explicit value must lie in ``[1, max(blocks_per_tile, 1)]``.
    """
    g0 = -(-blocks_per_tile // BITS_PER_WORD)
    g = granule_env()
    if g is not None:
        if g > max(blocks_per_tile, 1):
            raise ValueError(
                f"RTC_STREAM_GRANULE={g}: expected 'auto' or an integer in "
                f"[1, {max(blocks_per_tile, 1)}]"
            )
        return g
    for g in range(1, g0):
        per_col = n_tiles * (stream_words_per_pair(blocks_per_tile, g) + 1)
        rays = ((RAY_SUBLANES * SMEM_WORDS_BUDGET // per_col)
                // RAYS_PER_PROGRAM * RAYS_PER_PROGRAM)
        if rays >= 4096:
            return g
    return g0


def stream_tile_pad(plane, orig_idx, tile: int):
    """Pad the ``[12, T]`` plane with zero triangles and ``orig_idx [T]``
    with :data:`PAD_ORIG_IDX` to a multiple of ``tile``. Zero triangles
    never pass the test, and their blocks get no bit."""
    t = plane.shape[1]
    t_pad = round_up(t, tile)
    if t_pad != t:
        plane = torch.nn.functional.pad(plane, (0, t_pad - t))
        orig_idx = torch.nn.functional.pad(orig_idx, (0, t_pad - t),
                                           value=PAD_ORIG_IDX)
    return plane, orig_idx
