"""Triangle search dispatch: which kernel serves a search, and its preludes.

Counterpart of ``raytracingc_tpu/ops/intersect_pallas.py::search_triangles_pallas``
with the same thresholds, knobs and branch order (``:1832-1918``,
``:2051-2098``, ``:2155-2275``). ``T`` is the padded triangle count of the
accel (``128 * n_blocks``); ``fits`` is ``ceil(n_blocks / 31) <=
RTC_BITMASK_MAX_WORDS``; ``streamed`` is ``T > RTC_STREAM_MAX_T`` (tiles of
``RTC_STREAM_TILE`` triangles, the plane padded to whole tiles). Each route
names the TPU kernel it stands for:

* **brute**, K1 (``ops/search_brute.py``): ``RTC_KERNEL=brute``, or
  ``auto`` with ``n_live <= RTC_BRUTE_MAX`` (under ``RTC_CULL=range`` too).
  Original triangle order, no accel.
* **mxu**, K8 (``ops/intersect_mxu.py``): ``RTC_KERNEL=mxu``, whatever
  ``n_live``, while ``T <= MXU_MAX_TRIS`` (8,192) and ``ceil(n_blocks /
  31) <= 8``; past that the search prints the JAX package's notice on
  stderr and takes the ``packet`` routes below. Culls per 1,024-ray
  program (``culling.program_union_words``); dead lanes report misses.
* **bitmask**, K2 (``ops/search_bitmask.py``): ``fits``, not ``streamed``,
  ``RTC_CULL`` not ``range``.
* Past that, by ``RTC_STREAM_CULL`` (default ``range`` under
  ``RTC_CULL=range``, else ``packed``): streamed, **packed** K3
  (``ops/search_packed.py``), **words** K7 (``RTC_STREAM_ORDER=tile``) or K6
  (``ray``) (``ops/search_words.py``), or **range** K5
  (``ops/search_range.py``); resident and not ``fits``, packed K3 or words
  K6 over one tile of the whole plane; any other resident case, range K4.

A scene without an accel runs the packet kernels over :func:`trivial_accel`,
as the JAX package does (the mxu route packs its coefficient table per
call). Every branch but mxu gives the same result bit for bit; mxu agrees
within its contract (``ops/intersect_mxu.py``). A CUDA tensor launches the
branch's kernel, a CPU tensor runs the same branch's plain version. Nothing
falls back to another branch or device. Every wrapper runs under
``ops/no_tangent.no_tangent``: on the plain tensors under ``torch.func.jvp``
(whose wrapped tensors have no ``data_ptr``), with outputs that carry no
derivative in any autograd mode, the same bits and launches as without.
Left out: the JAX package's ray
slicing (``max_rays``, ``:1920-1985``), which bounds the TPU kernels' scalar
memory and changes no result; the CUDA kernels read their tables from
global memory.

Knobs, read on every call (parsed again whenever a raw value changes) and
validated loudly (``ValueError`` on a typo or an out-of-range integer):

* ``RTC_KERNEL``: ``auto`` (default), ``brute``, ``packet`` or ``mxu``.
* ``RTC_MXU_PRECISION``: ``split3`` (default) or ``highest``, the mxu
  route's product precision.
* ``RTC_CULL``: ``bitmask`` (default) or ``range``.
* ``RTC_STREAM_CULL``: ``packed``, ``words`` or ``range`` (default above).
* ``RTC_STREAM_ORDER``: ``tile`` (default) or ``ray``: which TPU grid the
  words route stands for (K7 or K6); both run the same CUDA kernel.
* ``RTC_BRUTE_MAX`` (>= 0, default :data:`BRUTE_MAX_TRIS`),
  ``RTC_BITMASK_MAX_WORDS`` (>= 0, default 8), ``RTC_STREAM_MAX_T`` (>= 0,
  default 65,536), ``RTC_STREAM_TILE`` (>= 1, default 16,384),
  ``RTC_STREAM_GRANULE`` (``auto`` or an integer in [1, blocks per tile];
  the packed route's granule, validated and ignored by the words routes,
  whose granule is ``ceil(blocks per tile / 31)``).
* ``RTC_COL_GROUP`` (1, 2, 4, 8 or 16) and ``RTC_EXTRACT`` (``reduce`` or
  ``roll``): the TPU kernels' grouped lockstep walk and column extraction.
  The CUDA kernels walk each packet on its own and address lanes directly,
  so the values are validated and change nothing.

Every default is the JAX package's value, measured on a TPU and not yet
re-measured on a GPU.

The culling prelude of a packet or mxu route is one ``rtc.cull`` span; its
packets are counted in ``search.cull_packets``. Every word route (bitmask,
packed, words, mxu) computes its words with one call of
``culling.cull_words`` over the route's boxes (the accel's blocks, or the
tile lists' union boxes built per call): the CUDA kernel on a card, its
plain version on the CPU. The range route's spans are torch slab tests
(``culling.packet_block_ranges``) on either device.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from raytracingc_tpu_torch.ops import culling
from raytracingc_tpu_torch.ops.accel import (
    BLOCK,
    TriangleAccel,
    trivial_accel,
    trivial_blocks,
)
from raytracingc_tpu_torch.ops.intersect_mxu import (
    MXU_MAX_TRIS,
    PRECISIONS,
    pack_coeffs_mxu,
    search_mxu,
)
from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
from raytracingc_tpu_torch.ops.search_brute import (
    pack_triangles,
    search_brute,
    search_brute_reference,
)
from raytracingc_tpu_torch.ops.search_packed import search_packed
from raytracingc_tpu_torch.ops.search_range import search_range
from raytracingc_tpu_torch.ops.search_words import search_words
from raytracingc_tpu_torch.scene.types import Triangles
from raytracingc_tpu_torch.utils.profiling import COUNTS, trace_annotation

BRUTE_MAX_TRIS = 1536
BITMASK_MAX_WORDS = 8
MXU_MAX_WORDS = 8  # the JAX kernel's unrolled union-word walks

_CHOICES = {
    "RTC_KERNEL": ("auto", "brute", "packet", "mxu"),
    "RTC_MXU_PRECISION": PRECISIONS,
    "RTC_CULL": ("bitmask", "range"),
    "RTC_STREAM_CULL": ("packed", "words", "range"),
    "RTC_STREAM_ORDER": ("tile", "ray"),
    "RTC_EXTRACT": ("reduce", "roll"),
    "RTC_COL_GROUP": ("1", "2", "4", "8", "16"),
}


def _choice(name: str, default: str) -> str:
    v = os.environ.get(name, default)
    if v not in _CHOICES[name]:
        raise ValueError(f"{name}={v!r}: expected one of {', '.join(_CHOICES[name])}")
    return v


def _int(name: str, default: int, minimum: int) -> int:
    v = os.environ.get(name, str(default))
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected an integer") from None
    if n < minimum:
        raise ValueError(f"{name}={v!r}: expected an integer >= {minimum}")
    return n


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The dispatch knobs of one search call, validated."""

    kernel: str
    cull: str
    stream_cull: str
    stream_order: str
    mxu_precision: str
    brute_max: int
    bitmask_max_words: int
    stream_max_t: int
    stream_tile: int

    @classmethod
    def read(cls) -> "Knobs":
        """The knobs of the environment as it stands: parsed once per set
        of raw values, and again whenever one of them changes. A value that
        fails to parse is never kept, so it raises on every call."""
        raw = tuple(map(os.environ.get, _KNOB_NAMES))
        if _parsed and _parsed[0] == raw:
            return _parsed[1]
        knobs = cls._parse()
        _parsed[:] = [raw, knobs]
        return knobs

    @classmethod
    def _parse(cls) -> "Knobs":
        kernel = _choice("RTC_KERNEL", "auto")
        cull = _choice("RTC_CULL", "bitmask")
        _choice("RTC_EXTRACT", "reduce")
        _choice("RTC_COL_GROUP", "8")
        culling.granule_env()
        return cls(
            kernel=kernel,
            cull=cull,
            stream_cull=_choice("RTC_STREAM_CULL",
                                "range" if cull == "range" else "packed"),
            stream_order=_choice("RTC_STREAM_ORDER", "tile"),
            mxu_precision=_choice("RTC_MXU_PRECISION", "split3"),
            brute_max=_int("RTC_BRUTE_MAX", BRUTE_MAX_TRIS, 0),
            bitmask_max_words=_int("RTC_BITMASK_MAX_WORDS", BITMASK_MAX_WORDS, 0),
            stream_max_t=_int("RTC_STREAM_MAX_T", culling.STREAM_MAX_RESIDENT_T, 0),
            stream_tile=_int("RTC_STREAM_TILE", culling.STREAM_TILE, 1),
        )


# Every environment variable Knobs._parse reads, and the last parse:
# [raw values, Knobs], empty before the first.
_KNOB_NAMES = (*_CHOICES, "RTC_STREAM_GRANULE", "RTC_BRUTE_MAX",
               "RTC_BITMASK_MAX_WORDS", "RTC_STREAM_MAX_T", "RTC_STREAM_TILE")
_parsed: list = []


@dataclasses.dataclass(frozen=True)
class Route:
    """Where a search goes: ``kernel`` is ``brute``, ``mxu``, ``bitmask``,
    ``packed``, ``words`` or ``range``, and ``tpu`` the TPU kernel of the
    JAX package that the route stands for (``K1`` .. ``K8``). A tiled route
    (packed, words, range) also has its tile (triangles), tile count and
    culling granule (0 for range, which has none)."""

    kernel: str
    tpu: str
    tile: int = 0
    n_tiles: int = 0
    granule: int = 0


def mxu_fits(n_blocks: int) -> bool:
    """Whether the mxu route takes a scene of ``n_blocks`` blocks."""
    return (n_blocks * BLOCK <= MXU_MAX_TRIS
            and -(-n_blocks // culling.BITS_PER_WORD) <= MXU_MAX_WORDS)


_BRUTE = Route("brute", "K1")


def route(n_live: int, n_blocks: int, knobs: Knobs) -> Route:
    """The branch ``search_triangles_pallas`` takes for this scene size."""
    if knobs.kernel == "brute" or (knobs.kernel == "auto"
                                   and n_live <= knobs.brute_max):
        return _BRUTE
    if knobs.kernel == "mxu" and mxu_fits(n_blocks):
        return Route("mxu", "K8")
    t = n_blocks * BLOCK
    fits = -(-n_blocks // culling.BITS_PER_WORD) <= knobs.bitmask_max_words
    sc = knobs.stream_cull
    if t > knobs.stream_max_t:
        tile = min(culling.round_up(knobs.stream_tile, BLOCK), t)
        n_tiles, bpt = -(-t // tile), tile // BLOCK
        if sc == "packed":
            return Route("packed", "K3", tile, n_tiles,
                         culling.stream_granule(bpt, n_tiles))
        if sc == "words":
            return Route("words", "K7" if knobs.stream_order == "tile" else "K6",
                         tile, n_tiles, -(-bpt // culling.BITS_PER_WORD))
        return Route("range", "K5", tile, n_tiles)
    if knobs.cull != "range" and fits:
        return Route("bitmask", "K2")
    if not fits and sc == "packed":
        return Route("packed", "K3", t, 1, culling.stream_granule(n_blocks, 1))
    if not fits and sc == "words":
        return Route("words", "K6", t, 1, -(-n_blocks // culling.BITS_PER_WORD))
    return Route("range", "K4", t, 1)


def _cull(o, d, alive, entry, *args):
    """The culling prelude ``entry(o, d, alive, *args)`` (a ``culling``
    entry), in the ``rtc.cull`` span, its packets counted in
    ``search.cull_packets``."""
    COUNTS["search.cull_packets"] += -(-o.shape[0] // culling.RAY_SUBLANES)
    with trace_annotation("rtc.cull"):
        return entry(o, d, alive, *args)


def search_triangles(o, d, tris: Triangles, n_live: int, alive=None,
                     backend: str = "auto", accel: TriangleAccel | None = None,
                     packet_only: bool = False):
    """Closest hit among the scene's triangles: ``(dst [R], idx [R])``,
    ``idx`` in original order, -1 on a miss.

    ``backend``: ``"auto"`` (the route's CUDA kernel on a CUDA tensor, its
    plain version on the CPU), ``"xla"`` (the accel-free plain scan on
    either device; the name is the JAX package's, kept for the CLI's A/B
    flag) or ``"pallas"`` (the CUDA kernels; raises on the CPU).

    ``alive``: optional bool ``[R]``. The brute and mxu routes report
    ``(MISS_DST, -1)`` for dead lanes. The packet routes build their culling
    bits from live lanes only and do not mask: a dead lane in a packet with
    a live lane gets its real hit, a packet of dead lanes misses (as in the
    JAX package).

    ``packet_only``: take the accel-table routes whatever ``RTC_KERNEL`` and
    ``n_live`` say (no brute, no mxu), as the JAX package's
    ``variant="packet"`` does for a block-sharded scene: those routes read
    ``accel.orig_idx``, which a shard's accel carries as global indices.
    The other knobs apply as always.
    """
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"backend={backend!r}: expected auto, xla or pallas")
    knobs = Knobs.read()
    if packet_only:
        knobs = dataclasses.replace(knobs, kernel="packet")
    o, d = o.contiguous(), d.contiguous()
    if backend == "xla":
        tri = pack_triangles(tris, n_live)
        return search_brute_reference(o, d, tri, n_live, alive)
    if backend == "pallas" and o.device.type != "cuda":
        raise RuntimeError(
            f"backend='pallas' needs a CUDA device; the rays are on {o.device}")
    n_blocks = trivial_blocks(tris.count) if accel is None else accel.n_blocks
    way = route(n_live, n_blocks, knobs)
    if way.kernel == "brute":  # the pack-free entry: no accel, no packing
        return search_brute(o, d, tris, n_live, alive)
    if accel is None:
        accel = trivial_accel(tris)
    if knobs.kernel == "mxu" and way.kernel != "mxu":
        # The JAX package's own routing rule, printed so that an A/B run
        # never times another kernel unknowingly.
        print(f"raytracingc_tpu_torch: RTC_KERNEL=mxu unsupported at "
              f"{accel.n_blocks * BLOCK} padded triangles (cap {MXU_MAX_TRIS}); "
              "falling back to the packet kernel", file=sys.stderr)

    if way.kernel == "mxu":
        words, flags = _cull(o, d, alive, culling.program_union_words, accel)
        coeffs = accel.mxu_coeffs
        if coeffs is None:
            coeffs = pack_coeffs_mxu(accel.triangles, accel.orig_idx)
        return search_mxu(o, d, words, flags, coeffs, accel.orig_idx,
                          knobs.mxu_precision, alive)
    plane = accel.packed_plane
    if plane is None:
        t = accel.triangles
        plane = torch.cat([t.a.T, (t.b - t.a).T, (t.c - t.a).T, t.normal.T])
    plane = plane.contiguous()
    if way.kernel == "bitmask":
        words = _cull(o, d, alive, culling.packet_block_masks, accel)
        return search_bitmask(o, d, words, plane, accel.orig_idx)
    plane, orig_idx = culling.stream_tile_pad(plane, accel.orig_idx, way.tile)
    bpt = way.tile // BLOCK
    if way.kernel == "packed":
        words = _cull(o, d, alive, culling.packet_tile_words_multi, accel,
                      way.n_tiles, bpt, way.granule)
        return search_packed(o, d, words, plane, orig_idx, way.tile, way.granule)
    if way.kernel == "words":
        words = _cull(o, d, alive, culling.packet_tile_words, accel,
                      way.n_tiles, bpt, way.granule)
        return search_words(o, d, words, plane, orig_idx, way.tile, way.granule)
    first, last = _cull(o, d, alive, culling.packet_block_ranges, accel)
    return search_range(o, d, first, last, plane, orig_idx)
