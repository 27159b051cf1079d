"""Triangle search dispatch: which kernel serves a search, and its preludes.

Counterpart of ``raytracingc_tpu/ops/intersect_pallas.py::search_triangles_pallas``
for the branches that are ported, with the same thresholds and knobs:

* **brute** (``ops/search_brute.py``): ``RTC_KERNEL=brute``, or ``auto``
  with ``n_live <= RTC_BRUTE_MAX``. Original triangle order, no accel.
* **bitmask** (``ops/search_bitmask.py``): ``ceil(n_blocks / 31) <=
  RTC_BITMASK_MAX_WORDS`` and ``T <= RTC_STREAM_MAX_T``.
* **packed, resident** (``ops/search_packed.py``): more blocks than that,
  ``T <= RTC_STREAM_MAX_T``; the whole plane is one tile.
* **packed, streamed**: ``T > RTC_STREAM_MAX_T``; tiles of
  ``RTC_STREAM_TILE`` triangles, the plane padded to whole tiles.

``T`` is the padded triangle count of the accel (``128 * n_blocks``). A
scene without an accel runs the packet kernels over :func:`trivial_accel`,
as the JAX package does. Every branch gives the same result; a CUDA tensor
launches the branch's kernel, a CPU tensor runs the same branch's plain
version. Nothing falls back to another branch or device.

Knobs, read on every call and validated loudly (``ValueError`` on a typo or
an out-of-range integer, ``NotImplementedError`` naming the ROADMAP item for
a value whose kernel is not ported):

* ``RTC_KERNEL``: ``auto`` (default), ``brute``, ``packet``; ``mxu`` is K8.
* ``RTC_CULL``: ``bitmask`` (default); ``range`` is K4 (and K5).
* ``RTC_STREAM_CULL``: ``packed`` (default); ``words`` and ``range`` are
  K5-K7.
* ``RTC_BRUTE_MAX`` (>= 0, default :data:`BRUTE_MAX_TRIS`),
  ``RTC_BITMASK_MAX_WORDS`` (>= 0, default 8), ``RTC_STREAM_MAX_T`` (>= 0,
  default 65,536), ``RTC_STREAM_TILE`` (>= 1, default 16,384),
  ``RTC_STREAM_GRANULE`` (``auto`` or an integer in [1, blocks per tile]).
* ``RTC_COL_GROUP`` (1, 2, 4, 8 or 16): the TPU kernels' grouped lockstep
  walk. The CUDA kernels walk each packet on its own, so the value is
  validated and changes nothing.

Every default is the JAX package's value, measured on a TPU and not yet
re-measured on a GPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from raytracingc_tpu_torch.ops import culling
from raytracingc_tpu_torch.ops.accel import BLOCK, TriangleAccel, trivial_accel
from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
from raytracingc_tpu_torch.ops.search_brute import (
    pack_triangles,
    search_brute,
    search_brute_reference,
)
from raytracingc_tpu_torch.ops.search_packed import search_packed
from raytracingc_tpu_torch.scene.types import Triangles

BRUTE_MAX_TRIS = 1536
BITMASK_MAX_WORDS = 8

_NOT_PORTED = {
    ("RTC_KERNEL", "mxu"): "the MXU kernel (ROADMAP Queue 2 K8)",
    ("RTC_CULL", "range"): "the range kernels (ROADMAP Queue 2 K4, K5)",
    ("RTC_STREAM_CULL", "range"): "the streamed range kernel (ROADMAP Queue 2 K5)",
    ("RTC_STREAM_CULL", "words"): "the streamed words kernels (ROADMAP Queue 2 K6, K7)",
}
_CHOICES = {
    "RTC_KERNEL": ("auto", ("auto", "brute", "packet", "mxu")),
    "RTC_CULL": ("bitmask", ("bitmask", "range")),
    "RTC_STREAM_CULL": ("packed", ("packed", "words", "range")),
}


def _choice(name: str) -> str:
    default, allowed = _CHOICES[name]
    v = os.environ.get(name, default)
    if v not in allowed:
        raise ValueError(f"{name}={v!r}: expected one of {', '.join(allowed)}")
    if (name, v) in _NOT_PORTED:
        raise NotImplementedError(
            f"{name}={v}: {_NOT_PORTED[name, v]} not ported yet")
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
    brute_max: int
    bitmask_max_words: int
    stream_max_t: int
    stream_tile: int

    @classmethod
    def read(cls) -> "Knobs":
        kernel = _choice("RTC_KERNEL")
        _choice("RTC_CULL")
        _choice("RTC_STREAM_CULL")
        group = os.environ.get("RTC_COL_GROUP", "8")
        if group not in ("1", "2", "4", "8", "16"):
            raise ValueError(f"RTC_COL_GROUP={group!r}: expected 1, 2, 4, 8 or 16")
        culling.granule_env()
        return cls(
            kernel=kernel,
            brute_max=_int("RTC_BRUTE_MAX", BRUTE_MAX_TRIS, 0),
            bitmask_max_words=_int("RTC_BITMASK_MAX_WORDS", BITMASK_MAX_WORDS, 0),
            stream_max_t=_int("RTC_STREAM_MAX_T", culling.STREAM_MAX_RESIDENT_T, 0),
            stream_tile=_int("RTC_STREAM_TILE", culling.STREAM_TILE, 1),
        )


@dataclasses.dataclass(frozen=True)
class Route:
    """Where a search goes: ``kernel`` is ``brute``, ``bitmask`` or
    ``packed``; a packed route also has its tile (triangles), tile count
    and granule."""

    kernel: str
    tile: int = 0
    n_tiles: int = 0
    granule: int = 0


def route(n_live: int, n_blocks: int, knobs: Knobs) -> Route:
    """The branch ``search_triangles_pallas`` takes for this scene size."""
    if knobs.kernel == "brute" or (knobs.kernel == "auto"
                                   and n_live <= knobs.brute_max):
        return Route("brute")
    t = n_blocks * BLOCK
    if t <= knobs.stream_max_t:
        if -(-n_blocks // culling.BITS_PER_WORD) <= knobs.bitmask_max_words:
            return Route("bitmask")
        tile = t
    else:
        tile = min(culling.round_up(knobs.stream_tile, BLOCK), t)
    n_tiles = -(-t // tile)
    return Route("packed", tile, n_tiles,
                 culling.stream_granule(tile // BLOCK, n_tiles))


def search_triangles(o, d, tris: Triangles, n_live: int, alive=None,
                     backend: str = "auto", accel: TriangleAccel | None = None):
    """Closest hit among the scene's triangles: ``(dst [R], idx [R])``,
    ``idx`` in original order, -1 on a miss.

    ``backend``: ``"auto"`` (the route's CUDA kernel on a CUDA tensor, its
    plain version on the CPU), ``"xla"`` (the accel-free plain scan on
    either device; the name is the JAX package's, kept for the CLI's A/B
    flag) or ``"pallas"`` (the CUDA kernels; raises on the CPU).

    ``alive``: optional bool ``[R]``. The brute route reports
    ``(MISS_DST, -1)`` for dead lanes. The packet routes build their culling
    bits from live lanes only and do not mask: a dead lane in a packet with
    a live lane gets its real hit, a packet of dead lanes misses (as in the
    JAX package).
    """
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"backend={backend!r}: expected auto, xla or pallas")
    knobs = Knobs.read()
    o, d = o.contiguous(), d.contiguous()
    if backend == "xla":
        tri = pack_triangles(tris, n_live)
        return search_brute_reference(o, d, tri, n_live, alive)
    if backend == "pallas" and o.device.type != "cuda":
        raise RuntimeError(
            f"backend='pallas' needs a CUDA device; the rays are on {o.device}")
    if accel is None:
        accel = trivial_accel(tris)
    way = route(n_live, accel.n_blocks, knobs)
    if way.kernel == "brute":
        return search_brute(o, d, pack_triangles(tris, n_live), n_live, alive)

    o_p, d_p, a_p = culling.packets(o, d, alive)
    plane = accel.packed_plane
    if plane is None:
        t = accel.triangles
        plane = torch.cat([t.a.T, (t.b - t.a).T, (t.c - t.a).T, t.normal.T])
    plane = plane.contiguous()
    if way.kernel == "bitmask":
        words = culling.packet_block_masks(o_p, d_p, a_p, accel)
        return search_bitmask(o, d, words, plane, accel.orig_idx)
    words = culling.packet_tile_words_multi(
        o_p, d_p, a_p, accel, way.n_tiles, way.tile // BLOCK, way.granule)
    plane, orig_idx = culling.stream_tile_pad(plane, accel.orig_idx, way.tile)
    return search_packed(o, d, words, plane, orig_idx, way.tile, way.granule)
