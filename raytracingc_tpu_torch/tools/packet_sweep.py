"""Packet-kernel timing (K2-K5): the bitmask, packed and range wrappers over
the timed scenes and their ray sets.

Times the bitmask (K2), packed (K3) and range (K4, K5) wrappers by CUDA
events on chip_smoke.py's timed packet scenes (box_scene tessellated to
10,240, 40,960 and 163,840 triangles: bitmask, packed resident, packed
streamed; 40,960 and 163,840 under ``RTC_CULL=range``: range resident and
streamed) at ``--rays`` rays, on the coherent and the secondary-like
packets of ``tools/packets.py``, and the range scenes also on packets of
which some span the whole plane (``wide_span_rays``). Each wrapper must
equal its plain version bit for bit.

It needs nothing newer than the package's first packet and range kernels,
so this file, ``tools/packets.py`` and ``tools/__init__.py`` can be copied
into an older checkout to time that checkout's kernels on the same rays (an
A/B of two commits).

    python -m raytracingc_tpu_torch.tools.packet_sweep [--rays 65536]
        [--iters 20] [--match K5]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.search_bitmask import (
    bitmask_table,
    search_bitmask,
    search_bitmask_reference,
)
from raytracingc_tpu_torch.ops.search_packed import (
    packed_table,
    search_packed,
    search_packed_reference,
)
from raytracingc_tpu_torch.ops.search_range import (
    range_table,
    search_range,
    search_range_reference,
)
from raytracingc_tpu_torch.tools import cuda_ms, knobs_set
from raytracingc_tpu_torch.tools.packets import (
    DEAD,
    RAY_SETS,
    packet_inputs,
    wide_span_rays,
)
from raytracingc_tpu_torch.tools.union_walk_ab import BOX_SCENE, load_scene

# (label, box_scene tessellation levels, knobs) of chip_smoke.py's timed
# K2-K5 cases.
RANGE = {"RTC_CULL": "range"}
SCENES = (("K2 box 10,240", 5, {}), ("K3 box 40,960 resident", 6, {}),
          ("K3 box 163,840 streamed", 7, {}),
          ("K4 box 40,960 (RTC_CULL=range)", 6, RANGE),
          ("K5 box 163,840 streamed (RTC_CULL=range)", 7, RANGE))
BOX_ORIGINS = ((-5.0, -5.0, -5.0), (5.0, 1.5, 5.0))  # inside box_scene's room


def case_calls(scene, o, d, alive):
    """``(route, wrapper call, plain call, tested pairs)`` of the dispatch's
    packet or range route for these rays on ``scene``."""
    accel = scene.accel
    way = search.route(scene.n_triangles, accel.n_blocks, search.Knobs.read())
    if way.kernel == "range":
        first, last = culling.packet_block_ranges(*culling.packets(o, d, alive), accel)
        plane, oi = culling.stream_tile_pad(accel.packed_plane, accel.orig_idx,
                                            way.tile)
        args = (o, d, first, last, plane, oi)
        table = range_table(first, last, plane.shape[1] // BLOCK)
        return (way, lambda: search_range(*args),
                lambda: search_range_reference(*args),
                int(table.sum()) * culling.RAY_SUBLANES * BLOCK)
    way, words, plane, oi = packet_inputs(scene, o, d, alive)
    if way.kernel == "bitmask":
        args = (o, d, words, plane, oi)
        wrapper, plain = search_bitmask, search_bitmask_reference
        table = bitmask_table(words, plane.shape[1] // BLOCK)
    else:
        args = (o, d, words, plane, oi, way.tile, way.granule)
        wrapper, plain = search_packed, search_packed_reference
        table = packed_table(words, way.tile // BLOCK, way.granule)
    return (way, lambda: wrapper(*args), lambda: plain(*args),
            int(table.sum()) * culling.RAY_SUBLANES * BLOCK)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raytracingc_tpu_torch.tools.packet_sweep",
                                description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=65536,
                   help="rays per case (a multiple of 8)")
    p.add_argument("--iters", type=int, default=20, help="timed calls per kernel")
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--match", default="",
                   help="time only the scenes whose label holds this text")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("packet_sweep times CUDA kernels: no CUDA device is available")
    if args.rays % 8:
        raise ValueError(f"--rays {args.rays}: expected a multiple of 8")

    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(dev)}; {args.rays} rays per case, "
          f"{DEAD:.0%} dead; {args.iters} timed calls", flush=True)
    rng = np.random.default_rng(args.seed)
    for label, levels, knobs in SCENES:
        if args.match not in label:
            continue
        scene = load_scene(BOX_SCENE, levels, dev)
        ray_sets = dict(RAY_SETS)
        if knobs is RANGE:
            ray_sets["whole-plane"] = lambda *a: wide_span_rays(*a, scene.accel)
        for set_name, make in ray_sets.items():
            o, d, alive = (torch.from_numpy(x).to(dev)
                           for x in make(rng, args.rays, *BOX_ORIGINS))
            with knobs_set(knobs):
                way, wrapper, plain, pairs = case_calls(scene, o, d, alive)
            want_d, want_i = wrapper()
            ref_d, ref_i = plain()
            if not (torch.equal(want_i, ref_i) and torch.equal(
                    want_d.view(torch.int32), ref_d.view(torch.int32))):
                raise AssertionError(f"{label} {set_name}: the wrapper differs "
                                     f"from the plain version")
            print(f"[wrappers] {label} {set_name} ({way.kernel} tile={way.tile} "
                  f"n_tiles={way.n_tiles} granule={way.granule}; {pairs} tested "
                  f"pairs): wrapper {cuda_ms(wrapper, args.iters):.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
