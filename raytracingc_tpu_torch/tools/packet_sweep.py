"""Packet-kernel timing (K2, K3): the two wrappers over the timed scenes and
both ray sets.

Times the bitmask (K2) and packed (K3) wrappers by CUDA events on
chip_smoke.py's three timed packet scenes (box_scene tessellated to 10,240,
40,960 and 163,840 triangles: bitmask, packed resident, packed streamed) at
``--rays`` rays, on the coherent and the secondary-like packets of
``tools/packets.py``. Each wrapper must equal its plain version bit for bit.

It needs nothing newer than the package's first packet kernels, so this file
and ``tools/packets.py`` can be copied into an older checkout to time that
checkout's kernels on the same rays (an A/B of two commits).

    python -m raytracingc_tpu_torch.tools.packet_sweep [--rays 65536]
        [--iters 20]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from raytracingc_tpu_torch.ops import culling
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
from raytracingc_tpu_torch.tools import cuda_ms
from raytracingc_tpu_torch.tools.packets import DEAD, RAY_SETS, packet_inputs
from raytracingc_tpu_torch.tools.union_walk_ab import BOX_SCENE, load_scene

# (label, box_scene tessellation levels) of chip_smoke.py's timed K2 / K3 cases.
SCENES = (("K2 box 10,240", 5), ("K3 box 40,960 resident", 6),
          ("K3 box 163,840 streamed", 7))
BOX_ORIGINS = ((-5.0, -5.0, -5.0), (5.0, 1.5, 5.0))  # inside box_scene's room


def pairs_of(way, words, plane) -> int:
    """The (ray, triangle) pairs the packets' words make the kernel test."""
    table = (bitmask_table(words, plane.shape[1] // BLOCK)
             if way.kernel == "bitmask"
             else packed_table(words, way.tile // BLOCK, way.granule))
    return int(table.sum()) * culling.RAY_SUBLANES * BLOCK


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raytracingc_tpu_torch.tools.packet_sweep",
                                description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=65536,
                   help="rays per case (a multiple of 8)")
    p.add_argument("--iters", type=int, default=20, help="timed calls per kernel")
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("packet_sweep times CUDA kernels: no CUDA device is available")
    if args.rays % 8:
        raise ValueError(f"--rays {args.rays}: expected a multiple of 8")

    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(dev)}; {args.rays} rays per case, "
          f"{DEAD:.0%} dead; {args.iters} timed calls", flush=True)
    rng = np.random.default_rng(args.seed)
    for label, levels in SCENES:
        scene = load_scene(BOX_SCENE, levels, dev)
        for set_name, make in RAY_SETS.items():
            o, d, alive = (torch.from_numpy(x).to(dev)
                           for x in make(rng, args.rays, *BOX_ORIGINS))
            way, words, plane, oi = packet_inputs(scene, o, d, alive)
            if way.kernel == "bitmask":
                wrapper = lambda: search_bitmask(o, d, words, plane, oi)
                plain = lambda: search_bitmask_reference(o, d, words, plane, oi)
            else:
                wrapper = lambda: search_packed(o, d, words, plane, oi, way.tile,
                                                way.granule)
                plain = lambda: search_packed_reference(o, d, words, plane, oi,
                                                        way.tile, way.granule)
            want_d, want_i = wrapper()
            ref_d, ref_i = plain()
            if not (torch.equal(want_i, ref_i) and torch.equal(
                    want_d.view(torch.int32), ref_d.view(torch.int32))):
                raise AssertionError(f"{label} {set_name}: the wrapper differs "
                                     f"from the plain version")
            print(f"[wrappers] {label} {set_name} ({way.kernel} tile={way.tile} "
                  f"n_tiles={way.n_tiles} granule={way.granule}; "
                  f"{pairs_of(way, words, plane)} tested pairs): wrapper "
                  f"{cuda_ms(wrapper, args.iters):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
