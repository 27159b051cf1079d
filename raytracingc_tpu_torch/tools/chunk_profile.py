"""Chunk profile: where the device time of one pixel chunk of a frame goes.

Traces ONE 65,536-pixel chunk of a frame of box_scene (tessellated) through
the production integrator, ``trace_accumulate``, as the renderer calls it
per chunk, on the card, and reports:

* the chunk's wall time unprofiled (host clock, ending in a synchronize)
  over ``--runs`` runs after a warm-up, and its traced rays per second;
* under torch.profiler, over one more run: the CUDA kernels launched, the
  device's busy time (the union of its kernel, copy and fill intervals) and
  its share of the profiled span, and the search kernels' launches and time
  (kernels whose name holds ``search_``) with their share of the busy time;
* for the packet routes (bitmask, packed), the primary call's culling
  prelude and search kernel, each by CUDA events.

    python -m raytracingc_tpu_torch.tools.chunk_profile [--tessellate 5]
        [-s 1920 1080] [--spp 2] [-b 8] [--chunk 16] [--runs 3]

Needs a CUDA card. The last line is one JSON object of these numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.ops import search
from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
from raytracingc_tpu_torch.ops.search_packed import search_packed
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.tools import BOX_SCENE, cuda_ms
from raytracingc_tpu_torch.tools.packets import packet_inputs
from raytracingc_tpu_torch.tools.union_walk_ab import load_scene

CHUNK = 65536  # the renderer's default pixel chunk


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_profile(fn) -> dict:
    """Run ``fn`` once under torch.profiler; its device-side numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    searches = [e for e in kernels if "search_" in e.name]
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    search_us = sum(e.time_range.end - e.time_range.start for e in searches)
    return {
        "profiled_span_ms": span / 1e3, "kernels": len(kernels),
        "device_busy_ms": busy / 1e3, "busy_share": busy / span,
        "search_launches": len(searches), "search_ms": search_us / 1e3,
        "search_share_of_busy": search_us / busy,
        "search_kernels": sorted({e.name for e in searches}),
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raytracingc_tpu_torch.tools.chunk_profile",
                                description=__doc__.splitlines()[0])
    p.add_argument("--triangles", default=BOX_SCENE, help="triangles.txt scene")
    p.add_argument("--tessellate", type=int, default=5, metavar="LEVELS")
    p.add_argument("-s", "--size", nargs=2, type=int, default=[1920, 1080],
                   metavar=("W", "H"))
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("-b", "--max-bounce", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=16,
                   help="which 65,536-pixel chunk of the frame")
    p.add_argument("--runs", type=int, default=3, help="unprofiled timed runs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chunk_profile measures the card: no CUDA device is available")
    dev = torch.device("cuda", 0)
    width, height = args.size
    lo = args.chunk * CHUNK
    if not 0 <= lo < width * height:
        raise ValueError(f"--chunk {args.chunk}: the frame has "
                         f"{-(-width * height // CHUNK)} chunks")
    hi = min(lo + CHUNK, width * height)
    scene = load_scene(args.triangles, args.tessellate, dev)
    o_all, d_all = primary_rays(Camera.look_at(device=dev), width, height)
    o, d = o_all[lo:hi].contiguous(), d_all[lo:hi].contiguous()
    ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    accel = scene.accel
    way = search.route(scene.n_triangles, accel.n_blocks, search.Knobs.read())

    def run():
        return trace_accumulate(o, d, scene, ids, seed=args.seed, spp=args.spp,
                                max_bounce=args.max_bounce, early_exit=True)

    run()
    torch.cuda.synchronize()
    walls, count = [], 0
    for _ in range(args.runs):
        t = time.perf_counter()
        _, count = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = sum(walls) / len(walls)
    row = {"device": torch.cuda.get_device_name(dev), "triangles": scene.n_triangles,
           "route": f"{way.kernel} ({way.tpu})", "pixels": [lo, hi - 1],
           "rays": count, "wall_s": walls, "rays_per_s": count / wall}
    row.update(device_profile(run))
    if way.kernel in ("bitmask", "packed"):
        alive = torch.ones((hi - lo,), dtype=torch.bool, device=dev)
        _, words, plane, oi = packet_inputs(scene, o, d, alive)
        if way.kernel == "bitmask":
            kernel = lambda: search_bitmask(o, d, words, plane, oi)
        else:
            kernel = lambda: search_packed(o, d, words, plane, oi, way.tile, way.granule)
        row["primary_prelude_ms"] = cuda_ms(lambda: packet_inputs(scene, o, d, alive), 20)
        row["primary_kernel_ms"] = cuda_ms(kernel, 20)
    print(f"{row['device']}: box_scene tessellated {args.tessellate} levels "
          f"({row['triangles']} triangles, {row['route']}), {width}x{height}, "
          f"{args.spp} spp, {args.max_bounce} bounces, pixels {lo}..{hi - 1}: "
          f"wall {wall:.4f} s unprofiled ({row['rays_per_s']:.4g} rays/s); "
          f"{row['kernels']} kernels, device busy {row['device_busy_ms']:.2f} ms "
          f"= {row['busy_share']:.1%} of the profiled span; search "
          f"{row['search_launches']} launches, {row['search_ms']:.2f} ms = "
          f"{row['search_share_of_busy']:.1%} of busy", flush=True)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
