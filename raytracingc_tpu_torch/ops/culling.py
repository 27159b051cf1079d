"""Culling preludes of the packet kernels: per-packet hit-bit words.

Counterpart of the XLA-side preludes in
``raytracingc_tpu/ops/intersect_pallas.py`` (``_slab_any_hit``,
``packet_block_masks``, ``packet_block_ranges``, ``packet_tile_words``,
``packet_tile_words_multi``, ``stream_words_per_pair``, ``_stream_granule``,
``_stream_tile_pad``, and the MXU launcher's per-program OR of the packet
words). Every entry takes the rays as they are, ``o, d [R, 3]`` and
``alive [R]`` or None. Rays are grouped in packets of :data:`RAY_SUBLANES`
(ray ``r`` is in packet ``r // 8``); a bit is set (or a block falls inside a
packet's span) iff some live lane of the packet passes the slab test of a
block's (or a granule's union) AABB. The results are integers equal to the
JAX package's bit for bit.

The word routes (bitmask, packed, words, mxu) take their route's boxes (the
accel's blocks, or :func:`tile_boxes`) to :func:`cull_words`: on a card the
hand-written CUDA kernel ``csrc/cull_words.cu``, on the CPU its plain
version :func:`cull_words_reference`. The range route's spans
(:func:`packet_block_ranges`) have no kernel: torch slab tests of the rays'
:func:`packets` on either device.

Memory: a slab test of C packets against G boxes makes ``(C, 8, G, 3)``
float32 temporaries, so the boxes are tested in groups sized to
:data:`SLAB_ELEMS_BUDGET` elements (the JAX package bounds the same with
``lax.map`` over words or tiles).
"""

from __future__ import annotations

import os

import torch

from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.ops.accel import PAD_ORIG_IDX, TriangleAccel
from raytracingc_tpu_torch.ops.no_tangent import no_tangent

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


def _pad_boxes(lo, hi, n: int, dim: int):
    """Pad box bounds along ``dim`` to ``n`` with inverted boxes."""
    pad = [0, 0] * (lo.dim() - 1 - dim) + [0, n - lo.shape[dim]]
    return (torch.nn.functional.pad(lo, pad, value=_BOX_BIG),
            torch.nn.functional.pad(hi, pad, value=-_BOX_BIG))


def packet_block_masks(o, d, alive, accel: TriangleAccel):
    """Per-packet hit words of the bitmask kernel: ``[C, n_words]`` int32.

    Bit ``j`` of word ``w`` is set iff block ``w * 31 + j`` passes the slab
    test for some live lane of the packet; ``n_words = ceil(n_blocks / 31)``.
    :func:`cull_words` on the accel's block boxes as they are.
    """
    return cull_words(o, d, alive, accel.aabb_lo, accel.aabb_hi)


def program_union_words(o, d, alive, accel: TriangleAccel):
    """Per-program union words of the MXU and union-walk kernels:
    ``(words [G, n_words], flags [G])`` int32, ``G = ceil(P / 128)``.

    ``words[g]`` is the bitwise OR of :func:`packet_block_masks` over the
    128 packets (1,024 rays) of program ``g``, the missing packets of the
    last program counting as dead; ``flags[g]`` is 1 iff a word is nonzero.
    """
    return program_union(packet_block_masks(o, d, alive, accel))


def program_union(masks):
    """:func:`program_union_words` of the packet words ``masks [P, W]``."""
    pad = round_up(masks.shape[0], PACKETS_PER_PROGRAM) - masks.shape[0]
    words = torch.nn.functional.pad(masks, (0, 0, 0, pad)).reshape(
        -1, PACKETS_PER_PROGRAM, masks.shape[1])
    while words.shape[1] > 1:  # an OR tree over the packets
        half = words.shape[1] // 2
        words = words[:, :half] | words[:, half:]
    words = words[:, 0].contiguous()
    return words, (words != 0).any(dim=1).to(torch.int32)


def packet_block_ranges(o, d, alive, accel: TriangleAccel):
    """Per-packet hitting-block span of the range kernel: ``(first [C],
    last [C])`` int32.

    ``first``/``last`` are the lowest and highest block that passes the slab
    test for some live lane of the packet; a packet that passes none has the
    empty span ``first =`` :data:`EMPTY_FIRST` (``2**30``), ``last = -1``,
    as in the JAX package. The blocks are tested in groups sized to
    :data:`SLAB_ELEMS_BUDGET`; a min or max over groups is the min or max
    over all blocks, so the grouping changes no bit.
    """
    o_p, d_p, a_p = packets(o, d, alive)
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


def _one_word(blocks_per_tile: int, granule: int) -> None:
    """Raise unless ``granule`` leaves at most 31 bits per tile."""
    if -(-blocks_per_tile // granule) > BITS_PER_WORD:
        raise ValueError(
            f"granule={granule}: {blocks_per_tile} blocks per tile need more "
            f"than {BITS_PER_WORD} bits; expected granule >= "
            f"{-(-blocks_per_tile // BITS_PER_WORD)}")


def packet_tile_words(o, d, alive, accel: TriangleAccel, n_tiles: int,
                      blocks_per_tile: int, granule: int):
    """Per-(packet, tile) word of the words kernel: ``[C, n_tiles]`` int32.

    Bit ``j`` of tile ``t``'s word covers the tile-local blocks ``[j *
    granule, ... + granule)`` and is set iff some live lane passes the slab
    test of their union box. This is the one-word case of
    :func:`packet_tile_words_multi`, so ``granule`` must leave at most 31
    bits per tile (the words routes use ``ceil(blocks_per_tile / 31)``).
    """
    _one_word(blocks_per_tile, granule)
    return packet_tile_words_multi(o, d, alive, accel, n_tiles,
                                   blocks_per_tile, granule)[..., 0]


def stream_words_per_pair(blocks_per_tile: int, granule: int) -> int:
    """Words per (packet, tile) at a given culling granule."""
    bits_per_tile = -(-blocks_per_tile // granule)
    return -(-bits_per_tile // BITS_PER_WORD)


def packet_tile_words_multi(o, d, alive, accel: TriangleAccel,
                            n_tiles: int, blocks_per_tile: int, granule: int):
    """Per-(packet, tile) words of the packed kernel: ``[C, n_tiles, W]``.

    ``W = stream_words_per_pair(blocks_per_tile, granule)``; bit ``j`` of
    word ``w`` of tile ``t`` covers the tile-local blocks
    ``[(w * 31 + j) * granule, ... + granule)`` and is set iff some live
    lane passes the slab test of their union box (:func:`tile_boxes`).
    Granule 1 is exact per-block culling; at any granule the set is a
    superset of the hit blocks, so the search result is the same.
    """
    lo, hi, n_words = tile_boxes(accel, n_tiles, blocks_per_tile, granule)
    return cull_words(o, d, alive, lo, hi).reshape(-1, n_tiles, n_words)


def tile_boxes(accel: TriangleAccel, n_tiles: int, blocks_per_tile: int,
               granule: int):
    """The boxes of :func:`packet_tile_words_multi`'s bits: ``(lo, hi
    [n_tiles * W * 31, 3], W)``, box ``(t * W + w) * 31 + j`` the union box
    of bit ``j`` of word ``w`` of tile ``t``; padding slots are inverted
    boxes, which pass no slab test."""
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
    return lo.reshape(-1, 3), hi.reshape(-1, 3), n_words


# ---------------------------------------------------------------------------
# The kernel (csrc/cull_words.cu) and its plain version.


def cull_words_reference(o, d, alive, lo, hi):
    """Plain version of :func:`cull_words`, lane by lane the kernel's
    arithmetic: each live lane's reciprocal direction (:func:`_inv_dir`),
    its six slab values per box, ``tmin`` the max over the axes of their
    minimums and ``tmax`` the min of their maximums (torch's minimum and
    maximum keep a NaN, as the kernel's ``min.NaN`` and ``max.NaN`` do),
    the box hit iff ``tmax >= max(tmin, 0)``; a packet's bit set iff a live
    lane hits a box with ``lo <= hi`` on every axis. Missing tail lanes are
    dead; boxes past ``N`` set no bit. Tested in groups of whole words to
    bound memory."""
    r, n = o.shape[0], lo.shape[0]
    c, n_words = -(-r // RAY_SUBLANES), -(-n // BITS_PER_WORD)
    dev = o.device
    pad = c * RAY_SUBLANES - r
    live = (torch.ones((r,), dtype=torch.bool, device=dev)
            if alive is None else alive)
    live = torch.nn.functional.pad(live, (0, pad)).reshape(c, RAY_SUBLANES, 1)
    o_l = torch.nn.functional.pad(o, (0, 0, 0, pad)).reshape(c, RAY_SUBLANES, 1, 3)
    inv = torch.nn.functional.pad(_inv_dir(d), (0, 0, 0, pad)).reshape(
        c, RAY_SUBLANES, 1, 3)
    valid = (lo <= hi).all(dim=1)
    bits = torch.ones((), dtype=torch.int32, device=dev) << torch.arange(
        BITS_PER_WORD, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.zeros((c, n_words), dtype=torch.int32, device=dev)
    step = BITS_PER_WORD * max(1, SLAB_ELEMS_BUDGET
                               // max(c * RAY_SUBLANES * BITS_PER_WORD * 3, 1))
    for b0 in range(0, n, step):
        g = min(step, n - b0)
        t0 = (lo[b0:b0 + g] - o_l) * inv  # [C, 8, g, 3]
        t1 = (hi[b0:b0 + g] - o_l) * inv
        x, y, z = (torch.minimum(t0[..., k], t1[..., k]) for k in range(3))
        tmin = torch.maximum(torch.maximum(x, y), z)
        x, y, z = (torch.maximum(t0[..., k], t1[..., k]) for k in range(3))
        tmax = torch.minimum(torch.minimum(x, y), z)
        hit = ((tmax >= torch.maximum(tmin, zero)) & live).any(dim=1)
        hit = hit & valid[b0:b0 + g]  # [C, g]
        g31 = round_up(g, BITS_PER_WORD)
        hit = torch.nn.functional.pad(hit, (0, g31 - g)).reshape(
            c, g31 // BITS_PER_WORD, BITS_PER_WORD)
        w0 = b0 // BITS_PER_WORD
        out[:, w0:w0 + g31 // BITS_PER_WORD] = torch.where(
            hit, bits, 0).sum(dim=2, dtype=torch.int32)
    return out


def _check_cull_args(o, d, alive, lo, hi) -> None:
    """Raise ``ValueError`` on what the kernel does not take: float32 ``o,
    d [R, 3]``, ``lo, hi [N, 3]``, bool ``alive [R]`` or None, contiguous,
    on one device, ``R < 2**31``."""
    r, n = o.shape[0], lo.shape[0]
    want = [("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
            ("lo", lo, torch.float32, (n, 3)), ("hi", hi, torch.float32, (n, 3))]
    if alive is not None:
        want.append(("alive", alive, torch.bool, (r,)))
    for name, x, dtype, shape in want:
        if x.dtype != dtype or x.shape != shape:
            raise ValueError(f"cull_words: {name} is {x.dtype} {tuple(x.shape)}, "
                             f"expected {dtype} {shape}")
        if not x.is_contiguous():
            raise ValueError(f"cull_words: {name} is not contiguous")
        if x.device != o.device:
            raise ValueError(f"cull_words: {name} is on {x.device}, o on {o.device}")
    if r >= 2**31:
        raise ValueError(f"cull_words: {r} rays; the kernel counts rays in int32")


@no_tangent
def cull_words(o, d, alive, lo, hi):
    """The packet words of rays ``o, d [R, 3]`` (``alive [R]`` or None)
    against boxes ``lo, hi [N, 3]``: ``[ceil(R / 8), ceil(N / 31)]`` int32,
    bit ``j`` of word ``w`` of packet ``p`` set iff box ``w * 31 + j`` passes
    the slab test for some live lane among rays ``8p .. 8p + 7``.

    A CPU tensor runs :func:`cull_words_reference`. A CUDA tensor launches
    ``csrc/cull_words.cu`` on the current stream (building the library on
    first use), with no sync, and counts the launch in
    ``cull_words.launches``; any other device raises."""
    _check_cull_args(o, d, alive, lo, hi)
    if o.device.type == "cpu":
        return cull_words_reference(o, d, alive, lo, hi)
    if o.device.type != "cuda":
        raise RuntimeError(f"cull_words: no kernel for device {o.device}")

    r, n = o.shape[0], lo.shape[0]
    words = torch.empty((-(-r // RAY_SUBLANES), -(-n // BITS_PER_WORD)),
                        dtype=torch.int32, device=o.device)
    with _build.card(o.device) as (lib, stream):
        code = lib.rtc_cull_words(
            o.data_ptr(), d.data_ptr(), None if alive is None else alive.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), r, n, words.data_ptr(), stream)
    _build.check(code, "cull_words launch")
    cull_words.launches += 1
    return words


cull_words.launches = 0


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
