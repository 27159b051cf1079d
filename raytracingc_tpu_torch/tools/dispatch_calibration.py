"""Brute/packet dispatch calibration: the grid that sets ``RTC_BRUTE_MAX``.

Counterpart of ``tools/dispatch_calibration.py`` (its ``main``), on the
in-repo ``examples/box_scene.txt`` in place of the reference's
``triangles.txt`` (not in this repository): a closed box around the camera,
the packet culler's worst case, tessellated to

* levels 3 and 4 (640 and 2,560 live triangles) at 128x128, 64 spp;
* levels 4 and 5 (2,560 and 10,240) at 1920x1080, 8 spp;

every cell at 8 bounces, seed 0, through ``render`` with its defaults
(production mode, 65,536-pixel chunks). Each cell renders in two legs, the
search forced to the brute scan (``brute``: ``RTC_BRUTE_MAX`` = 10,000,000,
K1) or to the accel routes (``packet``: ``RTC_BRUTE_MAX`` = 0, K2 at these
sizes): one warm run, then the best wall of two runs, each ending in a
device sync. The port reads ``RTC_BRUTE_MAX`` on every search call, so both
legs run in one process, each under :func:`tools.knobs_set` (the JAX tool
needed a process per leg: there the choice binds at trace). A dispatch
choice never changes a result: the legs' BMP bytes and traced rays are
equal in every cell, and :func:`calibrate` checks it.

    python -m raytracingc_tpu_torch.tools.dispatch_calibration [--device cuda]

Prints the card's name and power limit, then one line per (cell, leg) with
rays/s, the crossover per call width, and, last, one JSON object of the
cells. ``--device cuda`` (the default) needs a card; it never falls back to
the CPU. The default ``BRUTE_MAX_TRIS`` is not changed here: the grid only
measures where the crossover lies.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time

import torch

from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.ops import search
from raytracingc_tpu_torch.render.image import bmp_bytes, tonemap_to_bytes
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.tools import BOX_SCENE, card_name, device_arg, knobs_set
from raytracingc_tpu_torch.tools.union_walk_ab import load_scene

# (tessellation level, width, height, spp): the JAX tool's two call widths.
GRID = ((3, 128, 128, 64), (4, 128, 128, 64), (4, 1920, 1080, 8),
        (5, 1920, 1080, 8))
LEGS = {"brute": {"RTC_BRUTE_MAX": "10000000"}, "packet": {"RTC_BRUTE_MAX": "0"}}
MAX_BOUNCE = 8
SEED = 0
REPS = 2  # timed runs per (cell, leg), after one warm run


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate(device, grid=GRID, reps: int = REPS, on_cell=None) -> list[dict]:
    """Render every cell of ``grid`` in every leg of :data:`LEGS` (``{name:
    RTC_* knobs}``) on ``device``; one dict per (cell, leg), in grid order
    and legs interleaved per cell: ``leg``, ``level``, ``n_live``,
    ``width``, ``height``, ``spp``, ``route`` (the ``ops.search.Route`` the
    knobs pick for the scene), ``rays`` (traced, exact), ``seconds`` (the
    best of ``reps`` synced walls after one warm run), ``rays_per_s``,
    ``bmp`` (the tonemapped frame's BMP bytes) and ``bmp_sha256``.
    ``on_cell(row)`` is called after each (cell, leg). Raises
    ``AssertionError`` if the legs of a cell differ in BMP bytes or traced
    rays, or a repeated run in its traced rays."""
    cam = Camera.look_at()
    rows, scenes = [], {}
    for level, width, height, spp in grid:
        if level not in scenes:
            scenes[level] = load_scene(BOX_SCENE, level, device)
        scene = scenes[level]
        cell = []
        for leg, env in LEGS.items():
            with knobs_set(env):
                way = search.route(scene.n_triangles, scene.accel.n_blocks,
                                   search.Knobs.read())

                def run():
                    img, n = render(scene, cam, width, height, spp, MAX_BOUNCE,
                                    seed=SEED)
                    _sync(device)
                    return img, n

                img, rays = run()  # warm
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    _, n = run()
                    best = min(best, time.perf_counter() - t0)
                    if n != rays:
                        raise AssertionError(f"level {level} {leg}: {n} traced "
                                             f"rays, the warm run {rays}")
            bmp = bmp_bytes(tonemap_to_bytes(img.cpu().numpy()))
            row = dict(leg=leg, level=level, n_live=scene.n_triangles,
                       width=width, height=height, spp=spp, route=way,
                       rays=rays, seconds=best, rays_per_s=rays / best,
                       bmp=bmp, bmp_sha256=hashlib.sha256(bmp).hexdigest())
            cell.append(row)
            if on_cell is not None:
                on_cell(row)
        for row in cell[1:]:
            if row["bmp"] != cell[0]["bmp"] or row["rays"] != cell[0]["rays"]:
                raise AssertionError(
                    f"level {level} {width}x{height}: leg {row['leg']} "
                    f"({row['rays']} rays, BMP {row['bmp_sha256'][:16]}) != leg "
                    f"{cell[0]['leg']} ({cell[0]['rays']}, "
                    f"{cell[0]['bmp_sha256'][:16]})")
        rows.extend(cell)
    return rows


def crossover(rows: list[dict]) -> dict:
    """Per call width ``"WxH"``: the largest ``n_live`` at which the brute
    leg was at least as fast as the packet leg, and the smallest at which
    it was slower (None where no cell says)."""
    out = {}
    for width, height in sorted({(r["width"], r["height"]) for r in rows}):
        by = {}
        for r in rows:
            if (r["width"], r["height"]) == (width, height):
                by.setdefault(r["n_live"], {})[r["leg"]] = r["seconds"]
        brute_wins = [n for n, s in by.items() if s["brute"] <= s["packet"]]
        packet_wins = [n for n, s in by.items() if s["brute"] > s["packet"]]
        out[f"{width}x{height}"] = {
            "brute_up_to": max(brute_wins, default=None),
            "packet_from": min(packet_wins, default=None)}
    return out


def line(row: dict) -> str:
    return (f"{row['leg']} level={row['level']} tris={row['n_live']} "
            f"{row['width']}x{row['height']} spp={row['spp']}: "
            f"{row['rays_per_s']:.4e} rays/s ({row['rays']} rays, best "
            f"{row['seconds']:.4f} s, route {row['route'].kernel} "
            f"{row['route'].tpu}, BMP sha256 {row['bmp_sha256'][:16]})")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    device = device_arg(args.device)
    print(f"# device {args.device}: {card_name() if args.device == 'cuda' else 'CPU'}",
          flush=True)
    rows = calibrate(device, GRID, on_cell=lambda r: print(line(r), flush=True))
    cross = crossover(rows)
    for width, c in cross.items():
        print(f"# {width}: brute at least as fast up to {c['brute_up_to']} "
              f"triangles, packet faster from {c['packet_from']}", flush=True)
    print(json.dumps({"cells": [
        {**{k: v for k, v in r.items() if k != "bmp"},
         "route": dataclasses.asdict(r["route"])} for r in rows],
        "crossover": cross}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
