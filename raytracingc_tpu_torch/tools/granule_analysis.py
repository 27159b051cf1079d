"""Dead MT work inside set granule bits at streamed scale.

Counterpart of ``tools/granule_analysis.py`` (its ``main``), on the in-repo
``examples/box_scene.txt`` tessellated to level 7 or 8 (163,840 or 655,360
triangles) in place of the reference's ``suzannes.obj`` (not in this
repository). At these levels the ceiling emitter falls under the search's
``|det| < 1e-3`` guard and vanishes from renders (ROADMAP F4); only the
geometry is read here.

The words kernel (K6/K7, ``csrc/search_words.cu``) walks, for every set
granule bit of a packet's tile word, the bit's whole clipped run of
``granule`` blocks and lets the MT test reject. For the 1920x1080 primary
rays of the default camera, in 65,536-ray chunks of 8-ray packets, this
reports per granule ``g`` in ``(granule, 4, 3, 2, 1)`` (those <= the words
route's granule ``ceil(blocks per tile / 31)``):

* ``scanned``: the sum over the bits set at granule ``g`` of their run
  lengths (the blocks an MT walk at ``g`` tests; ``g = 1`` is exact
  per-block culling);
* ``vs_exact``: ``scanned / scanned(1)``, and ``dead_frac``: ``(scanned -
  scanned(1)) / scanned``, the share of those blocks whose own box no lane
  of the packet hits;

and ``active_col_frac``, the share of (packet, tile) pairs whose word at
the route's granule (``culling.packet_tile_words``) is not 0.

Granule groups never straddle a tile: tile ``t``'s bit ``b`` covers its
blocks ``[b * g, min((b + 1) * g, bpt))``, as the kernel's bits do
(``culling.packet_tile_words_multi``). The JAX tool groups the padded block
list ``g`` at a time across tile boundaries, which is the same grouping
only where ``g`` divides the blocks per tile.

    python -m raytracingc_tpu_torch.tools.granule_analysis [--device cuda]
        [--tessellate 7]

Prints the card's name and power limit, the scene line, one line per
granule and ``active_col_frac`` (the JAX tool's format), then one JSON
object of the counts. ``--device cuda`` (the default) needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.ops import culling
from raytracingc_tpu_torch.ops.accel import BLOCK, TriangleAccel
from raytracingc_tpu_torch.tools import BOX_SCENE, card_name, device_arg
from raytracingc_tpu_torch.tools.union_walk_ab import load_scene

CHUNK = 65536  # rays per chunk (the renderer's pixel chunk)
SLAB = 64  # granule groups per slab test (the JAX tool's lax.map slab)
GRANULES = (4, 3, 2, 1)  # besides the route's own granule


def layout(accel: TriangleAccel, tile: int) -> tuple[int, int, int]:
    """``(tile, n_tiles, blocks per tile)`` of the words route at ``tile``
    triangles per tile (clipped to the scene, rounded to whole blocks)."""
    t = accel.n_blocks * BLOCK
    tile = min(culling.round_up(tile, BLOCK), t)
    return tile, -(-t // tile), tile // BLOCK


def granules_for(blocks_per_tile: int) -> list[int]:
    """The route's granule ``ceil(bpt / 31)`` and those of
    :data:`GRANULES` below it, largest first."""
    g0 = -(-blocks_per_tile // culling.BITS_PER_WORD)
    return sorted({g0, *(g for g in GRANULES if g <= g0)}, reverse=True)


def _groups(accel: TriangleAccel, n_tiles: int, bpt: int, g: int):
    """Tile-local granule groups: their union boxes ``lo, hi [n_tiles *
    bits, 3]`` (inverted for pure padding) and run lengths."""
    bits = -(-bpt // g)
    lo, hi = culling._pad_boxes(accel.aabb_lo, accel.aabb_hi, n_tiles * bpt, 0)
    lo, hi = culling._pad_boxes(lo.reshape(n_tiles, bpt, 3),
                                hi.reshape(n_tiles, bpt, 3), bits * g, 1)
    lo = lo.reshape(n_tiles * bits, g, 3).amin(dim=1)
    hi = hi.reshape(n_tiles * bits, g, 3).amax(dim=1)
    start = torch.arange(bits, device=lo.device) * g
    run = (torch.clamp_max(start + g, bpt) - start).repeat(n_tiles)
    return lo, hi, run


def scanned_blocks(o_p, d_p, a_p, lo, hi, run) -> int:
    """The sum over (packet, group) pairs whose union box some live lane
    hits of the group's run length, tested :data:`SLAB` groups at a time so
    that the ``[C, 8, SLAB, 3]`` temporaries stay bounded (the JAX tool's
    ``lax.map`` over 64-group slabs)."""
    inv_p = culling._inv_dir(d_p)
    total = torch.zeros((), dtype=torch.int64, device=o_p.device)
    for s in range(0, lo.shape[0], SLAB):
        hit = culling.slab_any_hit(lo[s:s + SLAB], hi[s:s + SLAB], o_p, inv_p, a_p)
        total += (hit.to(torch.int64) * run[s:s + SLAB]).sum()
    return int(total)


def granule_counts(accel: TriangleAccel, o, d, tile: int, granules,
                   chunk: int = CHUNK) -> dict:
    """The counts of rays ``o, d [R, 3]`` against ``accel`` at ``tile``
    triangles per tile, in chunks of ``chunk`` rays of 8-ray packets (every
    lane live): ``{"scanned": {g: blocks}, "active_cols": n, "pairs": n}``,
    all Python integers. ``active_cols`` counts the (packet, tile) pairs
    whose word at the route's granule is not 0, ``pairs`` all of them."""
    tile, n_tiles, bpt = layout(accel, tile)
    g0 = -(-bpt // culling.BITS_PER_WORD)
    groups = {g: _groups(accel, n_tiles, bpt, g) for g in granules}
    scanned = dict.fromkeys(granules, 0)
    active = pairs = 0
    for i in range(0, o.shape[0], chunk):
        o_c, d_c = o[i:i + chunk], d[i:i + chunk]
        words = culling.packet_tile_words(o_c, d_c, None, accel, n_tiles, bpt, g0)
        o_p, d_p, a_p = culling.packets(o_c, d_c)
        active += int((words != 0).sum())
        pairs += words.numel()
        for g, (lo, hi, run) in groups.items():
            scanned[g] += scanned_blocks(o_p, d_p, a_p, lo, hi, run)
    return {"scanned": scanned, "active_cols": active, "pairs": pairs}


def report(counts: dict, blocks_per_tile: int) -> list[str]:
    """The JAX tool's lines: one per granule, then ``active_col_frac``."""
    exact = counts["scanned"].get(1, 0)
    out = []
    for g, s in counts["scanned"].items():
        words = -(-(-(-blocks_per_tile // g)) // culling.BITS_PER_WORD)
        out.append(f"granule={g} words/(col,tile)={words} scanned={s} "
                   f"vs_exact={s / max(exact, 1):.3f} "
                   f"dead_frac={(s - exact) / max(s, 1):.3f}")
    out.append(f"active_col_frac={counts['active_cols'] / max(counts['pairs'], 1):.3f}")
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--tessellate", type=int, default=7,
                   help="box_scene's level: 7 (163,840) or 8 (655,360 triangles)")
    args = p.parse_args(argv)
    device = device_arg(args.device)
    print(f"# device {args.device}: {card_name() if args.device == 'cuda' else 'CPU'}",
          flush=True)
    scene = load_scene(BOX_SCENE, args.tessellate, device)
    accel = scene.accel
    tile, n_tiles, bpt = layout(accel, culling.STREAM_TILE)
    granules = granules_for(bpt)
    print(f"# box_scene --tessellate {args.tessellate}: tris={scene.n_triangles} "
          f"padded={accel.n_blocks * BLOCK} blocks={accel.n_blocks} "
          f"tiles={n_tiles} bpt={bpt} granule={granules[0]} "
          f"bits/tile={-(-bpt // granules[0])}", flush=True)
    o, d = primary_rays(Camera.look_at(device=device), 1920, 1080)
    t0 = time.perf_counter()
    counts = granule_counts(accel, o, d, tile, granules)
    print(f"# {time.perf_counter() - t0:.1f}s over {-(-o.shape[0] // CHUNK)} chunks",
          flush=True)
    for ln in report(counts, bpt):
        print(ln, flush=True)
    print(json.dumps({"level": args.tessellate, "n_live": scene.n_triangles,
                      "tile": tile, "n_tiles": n_tiles, "blocks_per_tile": bpt,
                      **counts, "scanned": {str(g): s for g, s in
                                            counts["scanned"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
