"""Seeded packet workloads of the packet kernels (K2-K7), shared by
chip_smoke.py, the tools and the tests: two ray sets in packets of 8 with
one share of dead lanes, a third for the range and words kernels' longest
walks, and the default dispatch's packet-route inputs for a scene. Not a
tool: importing it runs nothing.

* :func:`packet_rays` (coherent): a shared origin region and a shared
  direction up to a small jitter, as adjacent pixels' rays;
* :func:`secondary_rays` (secondary-like): a shared origin region but
  independent unit directions, as the packets of compacted lanes after a
  diffuse bounce;
* :func:`wide_span_rays`: coherent packets, some of which span the whole
  plane (their lists hold the plane's first and last block);
* :func:`soup_scene`: a seeded triangle soup with equal-distance
  duplicates, and the box its rays start in.
"""

from __future__ import annotations

import numpy as np

from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops.accel import BLOCK

DEAD = 0.3  # share of dead lanes in both ray sets
SOUP_ORIGINS = ((-8.0, -8.0, -8.0), (8.0, 8.0, 8.0))  # around soup_scene's cube


def _packet_origins(rng, n_rays: int, lo, hi):
    """``(packets, origins)``: one origin per packet of 8 drawn in the box
    [lo, hi], each lane jittered around it."""
    n_pk = -(-n_rays // 8)
    o = np.repeat(rng.uniform(lo, hi, (n_pk, 3)), 8, axis=0)[:n_rays]
    return n_pk, (o + rng.normal(size=(n_rays, 3)) * 0.02).astype(np.float32)


def _unit(d):
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def packet_rays(rng, n_rays: int, lo, hi):
    """``(o, d, alive)``: rays in packets of 8 that share an origin region
    and a direction up to a small jitter; a share DEAD of lanes dead."""
    n_pk, o = _packet_origins(rng, n_rays, lo, hi)
    d = np.repeat(rng.normal(size=(n_pk, 3)), 8, axis=0)[:n_rays]
    d = _unit(d + rng.normal(size=(n_rays, 3)) * 0.02)
    return o, d, rng.uniform(size=n_rays) >= DEAD


def secondary_rays(rng, n_rays: int, lo, hi):
    """``(o, d, alive)``: rays in packets of 8 that share an origin region
    (as in :func:`packet_rays`) but each draw an independent unit direction;
    a share DEAD of lanes dead."""
    _, o = _packet_origins(rng, n_rays, lo, hi)
    d = _unit(rng.normal(size=(n_rays, 3)))
    return o, d, rng.uniform(size=n_rays) >= DEAD


RAY_SETS = {"coherent": packet_rays, "secondary": secondary_rays}


def wide_span_rays(rng, n_rays: int, lo, hi, accel, every: int = 8):
    """``(o, d, alive)``: :func:`packet_rays`, but in every ``every``-th
    packet lanes 0 and 1 are alive and aim at the centres of the first and
    the last block's boxes of ``accel``, the two ends of the Morton order:
    those packets' block spans (ops/culling.py::packet_block_ranges) cover
    the whole plane, and their rays' nearest hits may lie in any block."""
    o, d, alive = packet_rays(rng, n_rays, lo, hi)
    centre = ((accel.aabb_lo + accel.aabb_hi) / 2).cpu().numpy()
    for lane, block in ((0, 0), (1, accel.n_blocks - 1)):
        r = np.arange(lane, n_rays, 8 * every)
        d[r] = _unit(centre[block] - o[r])
        alive[r] = True
    return o, d, alive


def packet_inputs(scene, o, d, alive):
    """``(route, words, plane, orig_idx)`` of the default dispatch's packet
    route for these rays on ``scene`` (a loaded scene with its accel), the
    words computed by the route's culling entry, as the dispatch computes
    them."""
    accel = scene.accel
    way = search.route(scene.n_triangles, accel.n_blocks, search.Knobs.read())
    if way.kernel == "bitmask":
        words = culling.packet_block_masks(o, d, alive, accel)
        return way, words, accel.packed_plane, accel.orig_idx
    if way.kernel != "packed":
        raise ValueError(f"{way}: not a packet route")
    plane, oi = culling.stream_tile_pad(accel.packed_plane, accel.orig_idx,
                                        way.tile)
    words = culling.packet_tile_words_multi(o, d, alive, accel, way.n_tiles,
                                            way.tile // BLOCK, way.granule)
    return way, words, plane, oi


def soup_scene(rng, n_live: int):
    """``(Triangles, n_live)``: a soup of ``n_live`` triangles in a 12-unit
    cube, every 7th duplicating an earlier one (so that equal distances
    occur), every other normal flipped (both backface-cull outcomes). Edges
    shrink as the count grows, so that every soup has about the same
    surface area and most rays from :data:`SOUP_ORIGINS` hit."""
    from raytracingc_tpu_torch.scene.builder import triangles_from_arrays

    edge = 0.15 * (163840 / n_live) ** 0.5
    a = rng.uniform(-6, 6, (n_live, 3))
    b = a + rng.normal(size=(n_live, 3)) * edge
    c = a + rng.normal(size=(n_live, 3)) * edge
    verts = np.stack([a, b, c], axis=1).astype(np.float32)
    dup = np.arange(7, n_live, 7)
    verts[dup] = verts[dup // 2]
    nrm = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    nrm[::2] *= -1.0
    return triangles_from_arrays(
        verts, nrm.astype(np.float32), np.full((n_live, 3), 0.5, np.float32),
        np.zeros(n_live, np.float32), np.zeros(n_live, np.float32))
