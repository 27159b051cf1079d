#!/usr/bin/env python3
"""Readings that the correctness limits of a cell are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 0]

In one process (one set-up of the program): for every ``--seeds`` seed a
short window of the cell (``--seconds``; 0 runs one frame or the fewest
steps) and the numbers its check compares; then for every
``--control-seeds`` seed the same numbers with the control in the
program's place: the reference computed in bfloat16, the precision below
the configuration's float32. A ``fit`` cell also reads two faults planted
in the reference put in the program's place: half of the rays left out of
every step's trace (``half``), and the radiance of the image's first row
doubled where it is produced (``altered``). A step that leaves its state
unchanged reads 1 on ``update_gap`` by that number's definition and needs
no run. One JSON line per reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def half_rays(o, d, ids, sc, seed, spp, max_bounce, block_pairs):
    """The reference with the second half of the rays left out."""
    import torch

    from portbench.reference.tracer import radiance

    n = o.shape[0] // 2
    rad, count = radiance(o[:n], d[:n], ids[:n], sc, seed, spp, max_bounce,
                          block_pairs=block_pairs)
    return torch.cat([rad, torch.zeros_like(rad)]), count


def first_row_doubled(width):
    """The reference with the radiance of the first ``width`` pixels
    doubled."""
    import torch

    from portbench.reference.tracer import radiance

    def render(o, d, ids, sc, seed, spp, max_bounce, block_pairs):
        rad, count = radiance(o, d, ids, sc, seed, spp, max_bounce, block_pairs=block_pairs)
        scale = torch.ones_like(rad)
        scale[:width] = 2.0
        return rad * scale, count

    return render


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch

    from portbench.lib.check import CHECKS
    from portbench.lib.traffic import KINDS
    from portbench.lib.spec import load_cell
    from portbench.run import require_cards, set_cache_dirs

    set_cache_dirs()
    cell = load_cell(args.workload)
    require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    kind = cell.traffic["kind"]
    check = CHECKS[kind]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    card = torch.cuda.get_device_name(dev)
    warmed = False
    for seed, mode in [(s, None) for s in seeds] + [(s, "control") for s in controls]:
        t0 = time.perf_counter()
        load = KINDS[kind](cell.config, cell.traffic, seed, dev, False,
                               keep=cell.check.get("frames", 0))
        if not warmed:
            load.warm()
            warmed = True
        if kind == "fit" and not hasattr(load, "step_s"):
            load.step_s = 1.0
        record = load.window(args.seconds)
        readings = {}
        if mode is None:
            readings["program"], _ = check(load, record, cell.check)
        elif kind == "frames":
            readings["bf16"], _ = check(load, record, cell.check, control=torch.bfloat16)
        else:
            width = cell.traffic["width"]
            for name, ctl in (("bf16", {"dtype": torch.bfloat16}),
                              ("half", {"render": half_rays}),
                              ("altered", {"render": first_row_doubled(width)})):
                readings[name], _ = check(load, record, cell.check, control=ctl)
        for name, numbers in readings.items():
            print(json.dumps({"cell": cell.name, "seed": seed, "side": name,
                              "numbers": numbers, "attempted": record["attempted"],
                              "seconds": time.perf_counter() - t0, "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
