"""Block-AABB acceleration structure: Morton-sorted triangles, 128-blocks.

Counterpart of ``raytracingc_tpu/ops/accel.py``. Live triangles are sorted
on the host by the 30-bit Morton code of their centroid, so spatially near
triangles sit in the same aligned block of :data:`BLOCK` triangles; each
block gets an AABB. The packet kernels slab-test a ray packet against the
block AABBs (``ops/culling.py``) and run Möller–Trumbore only on the blocks
that pass.

The kernels carry each slot's ORIGINAL triangle index and break distance
ties toward the lowest one, so results equal the unsorted brute-force scan
whatever the permutation. The sort runs in numpy with the JAX package's
code (``np.argsort(kind="stable")`` on uint32 codes), so both packages give
the same permutation, bounds and plane bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingc_tpu_torch.scene.types import Triangles

BLOCK = 128  # triangles per AABB block
PAD_ORIG_IDX = 2**30  # orig_idx of padding slots: loses every tie
_AABB_BIG = 3.0e38  # "always hit" sentinel of trivial accels


@dataclasses.dataclass(frozen=True)
class TriangleAccel:
    """Morton-permuted triangle soup + per-128-block AABBs.

    ``triangles``: the scene's triangles in permuted order (padding at the
    tail). ``orig_idx [T]`` int32: permuted slot → original index
    (:data:`PAD_ORIG_IDX` on padding slots). ``aabb_lo/hi [B, 3]``: block
    bounds; a padding-only block gets an inverted box that no ray hits.
    ``perm_of_orig [T]`` int32: original index → permuted slot (the resolve's
    locality-sorted gather). ``packed_plane [12, T]`` f32: rows A, AB, AC, N
    of the permuted triangles, the packet kernels' triangle input.
    ``mxu_coeffs [6T, 16]`` f32: the MXU kernel's coefficient table
    (``ops/intersect_mxu.py::pack_coeffs_mxu``), packed once per scene when
    ``T <= MXU_MAX_TRIS`` (past that the kernel does not run). A trivial
    accel has none of the three; the MXU search packs its table per call.
    """

    triangles: Triangles
    orig_idx: torch.Tensor
    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor
    mxu_coeffs: torch.Tensor | None = None
    perm_of_orig: torch.Tensor | None = None
    packed_plane: torch.Tensor | None = None

    @property
    def n_blocks(self) -> int:
        return self.aabb_lo.shape[0]

    def to(self, device) -> "TriangleAccel":
        move = lambda x: None if x is None else x.to(device)
        return dataclasses.replace(
            self,
            triangles=self.triangles.to(device),
            orig_idx=self.orig_idx.to(device),
            aabb_lo=self.aabb_lo.to(device),
            aabb_hi=self.aabb_hi.to(device),
            mxu_coeffs=move(self.mxu_coeffs),
            perm_of_orig=move(self.perm_of_orig),
            packed_plane=move(self.packed_plane),
        )


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit xyz quantized coords into a 30-bit Morton code."""

    def split(v: np.ndarray) -> np.ndarray:
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    x, y, z = (split(q[:, i].astype(np.uint32)) for i in range(3))
    return x | (y << 1) | (z << 2)


def build_accel(tris: Triangles, n_live: int) -> TriangleAccel:
    """Sort live triangles by centroid Morton code and bound each block.

    Runs on the host in numpy; the result's tensors live on ``tris``'s
    device.
    """
    host = {f.name: getattr(tris, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(tris)}
    a, b, c = host["a"], host["b"], host["c"]
    t = a.shape[0]

    if n_live > 0:
        cent = (a[:n_live] + b[:n_live] + c[:n_live]) / 3.0
        lo = cent.min(axis=0)
        span = np.maximum(cent.max(axis=0) - lo, 1e-12)
        q = np.clip(((cent - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
        order = np.argsort(_morton3(q), kind="stable").astype(np.int32)
    else:
        order = np.zeros((0,), np.int32)
    perm = np.concatenate([order, np.arange(n_live, t, dtype=np.int32)])

    orig = perm.copy()
    orig[n_live:] = PAD_ORIG_IDX

    n_blocks = t // BLOCK
    pa, pb, pc = a[perm], b[perm], c[perm]
    lo_blocks = np.full((n_blocks, 3), _AABB_BIG, np.float32)
    hi_blocks = np.full((n_blocks, 3), -_AABB_BIG, np.float32)
    for blk in range(n_blocks):
        s, e = blk * BLOCK, min((blk + 1) * BLOCK, n_live)
        if s >= n_live:
            continue  # padding-only block: inverted AABB, never hit
        vs = np.concatenate([pa[s:e], pb[s:e], pc[s:e]], axis=0)
        lo_blocks[blk] = vs.min(axis=0)
        hi_blocks[blk] = vs.max(axis=0)

    inv = np.empty((t,), np.int32)
    inv[perm] = np.arange(t, dtype=np.int32)
    plane = np.concatenate(
        [pa.T, (pb - pa).T, (pc - pa).T, host["normal"][perm].T], axis=0
    ).astype(np.float32)

    # The MXU table is packed on the host, so its bits do not depend on the
    # device; only for scenes the MXU kernel accepts (384 B per triangle).
    from raytracingc_tpu_torch.ops.intersect_mxu import MXU_MAX_TRIS, pack_coeffs_mxu

    host_t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    permuted = Triangles(**{k: host_t(v[perm]) for k, v in host.items()})
    coeffs = (pack_coeffs_mxu(permuted, host_t(orig)) if t <= MXU_MAX_TRIS
              else None)
    dev = tris.a.device
    put = lambda x: None if x is None else x.to(dev)
    return TriangleAccel(
        triangles=permuted.to(dev),
        orig_idx=put(host_t(orig)),
        aabb_lo=put(host_t(lo_blocks)),
        aabb_hi=put(host_t(hi_blocks)),
        mxu_coeffs=put(coeffs),
        perm_of_orig=put(host_t(inv)),
        packed_plane=put(host_t(plane)),
    )


def refresh_accel(accel: TriangleAccel, tris: Triangles, n_live: int) -> TriangleAccel:
    """Recompute the accel's values from ``tris`` on its static permutation.

    Counterpart of the JAX package's ``refresh_accel``, the accel of
    geometry training: ``build_accel`` freezes a copy of the triangles, which
    goes stale once vertices move. This keeps the host-built Morton order
    (``orig_idx``, ``perm_of_orig``) and regenerates, with tensor ops on
    ``tris``'s device, everything the kernels read: the permuted triangles,
    the live-only block AABBs (padding rows masked with ``±_AABB_BIG``, so a
    padding-only block keeps its inverted never-hit box) and the ``(12, T)``
    plane. The result equals ``build_accel`` bit for bit on the same geometry
    and permutation, and stays exact for any geometry; only the culling
    quality ages as the vertices leave their Morton order. ``mxu_coeffs`` is
    None: the training path never takes the mxu route.
    """
    t = tris.count
    if accel.perm_of_orig is None:
        raise ValueError("refresh_accel needs a host-built accel; a trivial accel "
                         "carries no permutation to refresh")
    if accel.orig_idx.shape[0] != t:
        raise ValueError(f"accel covers {accel.orig_idx.shape[0]} triangle rows, "
                         f"the triangles have {t}")
    # Padding slots carry PAD_ORIG_IDX: clipped onto row t - 1, an all-zero
    # padding row whenever padding slots exist (n_live < t).
    src = accel.orig_idx.long().clamp_max(t - 1)
    permuted = Triangles(**{f.name: getattr(tris, f.name)[src]
                            for f in dataclasses.fields(Triangles)})
    live = (torch.arange(t, device=src.device) < n_live)[:, None]

    def bound(pick, fill):
        a, b, c = (torch.where(live, v, fill) for v in (permuted.a, permuted.b,
                                                        permuted.c))
        return pick(pick(a, b), c).reshape(t // BLOCK, BLOCK, 3)

    plane = torch.cat([permuted.a.T, (permuted.b - permuted.a).T,
                       (permuted.c - permuted.a).T, permuted.normal.T], dim=0)
    return TriangleAccel(
        triangles=permuted,
        orig_idx=accel.orig_idx,
        aabb_lo=bound(torch.minimum, _AABB_BIG).amin(dim=1),
        aabb_hi=bound(torch.maximum, -_AABB_BIG).amax(dim=1),
        mxu_coeffs=None,
        perm_of_orig=accel.perm_of_orig,
        packed_plane=plane,
    )


def trivial_blocks(t: int) -> int:
    """Blocks of the trivial accel of ``t`` triangles."""
    return max(t // BLOCK, 1)


def trivial_accel(tris: Triangles) -> TriangleAccel:
    """Identity accel: no reorder, every block 'always hit' (brute force)."""
    t = tris.count
    n_blocks = trivial_blocks(t)
    dev = tris.a.device
    return TriangleAccel(
        triangles=tris,
        orig_idx=torch.arange(t, dtype=torch.int32, device=dev),
        aabb_lo=torch.full((n_blocks, 3), -_AABB_BIG, dtype=torch.float32,
                           device=dev),
        aabb_hi=torch.full((n_blocks, 3), _AABB_BIG, dtype=torch.float32,
                           device=dev),
    )
