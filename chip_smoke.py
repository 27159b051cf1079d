"""Smoke run of raytracingc_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from this checkout's sources (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card bit for bit, drives the renderer's main path through the CLI (the
user's entry point) at every kernel's scene size, and compares a small
render on the card with the same render on the CPU. Each phase prints one
line per step; any failure raises and the script exits non-zero without
printing a result.

The last lines are the card's name and power limit as nvidia-smi reports
them, one JSON object describing each kernel, and the result object
``{"ok": true, "device": {...}}``. Uses only raytracingc_tpu_torch (no JAX).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BOX_SCENE = os.path.join(HERE, "examples", "box_scene.txt")

# Phase 3: the kernel against its plain version, bit for bit.
PHASE3_N_LIVE = (1, 10, 255, 256, 257, 640, 1536)
PHASE3_RAYS = (65536, 100003)  # one full pixel chunk, one ragged size
PHASE3_DEAD = 0.3
TIMED_N_LIVE = (10, 640)  # box_scene, and box_scene tessellated 64-fold
TIMED_RAYS = 65536

# Phase 3b: the packet kernels against their plain versions, bit for bit,
# and their live-lane winners against the brute scan over all live
# triangles. (label, scene, live triangles, knobs, expected kernel); the
# scene is a seeded soup or box_scene tessellated to that count, and the
# label starts with the TPU kernel that the route stands for (checked).
PACKET_CASES = (
    ("K2 soup 1,600 (1 word)", "soup", 1600, {}, "bitmask"),
    ("K2 soup 10,240 (3 words)", "soup", 10240, {}, "bitmask"),
    ("K2 box 10,240 (3 words)", "box", 10240, {}, "bitmask"),
    ("K2 soup 31,744 (8 words)", "soup", 31744, {}, "bitmask"),
    ("K3 soup 40,960 resident", "soup", 40960, {}, "packed"),
    ("K3 box 40,960 resident", "box", 40960, {}, "packed"),
    ("K3 box 40,960 resident, granule 4", "box", 40960,
     {"RTC_STREAM_GRANULE": "4"}, "packed"),
    ("K3 soup 163,840 streamed", "soup", 163840, {}, "packed"),
    ("K3 box 163,840 streamed", "box", 163840, {}, "packed"),
    ("K3 box 163,840 streamed, tile 12,000", "box", 163840,
     {"RTC_STREAM_TILE": "12000"}, "packed"),
    ("K4 soup 10,240 (RTC_CULL=range)", "soup", 10240, {"RTC_CULL": "range"},
     "range"),
    ("K4 box 40,960 (RTC_CULL=range)", "box", 40960, {"RTC_CULL": "range"},
     "range"),
    ("K5 box 163,840 streamed (RTC_CULL=range)", "box", 163840,
     {"RTC_CULL": "range"}, "range"),
    ("K5 box 163,840 streamed, tile 12,000 (RTC_CULL=range)", "box", 163840,
     {"RTC_CULL": "range", "RTC_STREAM_TILE": "12000"}, "range"),
    ("K6 box 40,960 resident (RTC_STREAM_CULL=words)", "box", 40960,
     {"RTC_STREAM_CULL": "words"}, "words"),
    ("K6 box 163,840 streamed (RTC_STREAM_CULL=words RTC_STREAM_ORDER=ray)",
     "box", 163840, {"RTC_STREAM_CULL": "words", "RTC_STREAM_ORDER": "ray"},
     "words"),
    ("K7 box 163,840 streamed (RTC_STREAM_CULL=words)", "box", 163840,
     {"RTC_STREAM_CULL": "words"}, "words"),
)
# Timed at R = TIMED_RAYS (kernel, plain) at the main path's shapes: {label:
# iterations of the plain version}. The range kernels' plain version tests
# every block of each span, so its time grows with the span: fewer runs.
TIMED_PACKET = {
    "K2 box 10,240 (3 words)": 3,
    "K3 box 40,960 resident": 3,
    "K3 box 163,840 streamed": 3,
    "K4 box 40,960 (RTC_CULL=range)": 1,
    "K5 box 163,840 streamed (RTC_CULL=range)": 1,
    "K6 box 40,960 resident (RTC_STREAM_CULL=words)": 3,
    "K6 box 163,840 streamed (RTC_STREAM_CULL=words RTC_STREAM_ORDER=ray)": 3,
    "K7 box 163,840 streamed (RTC_STREAM_CULL=words)": 3,
}

# Phase 4: the main path through the CLI, in default mode on box_scene.
# (a) is the CLI's own default workload (128x128, 10 bounces) with spp cut
# from the default 4000 to 256 to bound the run time; (b) and (c) are the
# tracked 1920x1080, 8 spp, 8 bounces configuration, (c) tessellated to 640
# live triangles; (d)-(f) tessellate box_scene past the brute kernel's
# range, one run per packet route, at 1920x1080 and 8 bounces with spp cut
# from 8 to 2 to bound the run time. (g)-(j) are the A/B culling routes, with
# the flags of (d)-(f), under the RTC_* knobs their users set: each must
# write a BMP byte-identical to its default-route twin's and trace as many
# rays. (label, flags, image shape, kernel, knobs, twin).
_TESS = ["-s", "1920", "1080", "--spp", "2", "-b", "8", "--tessellate"]
MAIN_RUNS = (
    ("a: 128x128, 10 bounces, 256 spp (CLI defaults, spp cut from 4000)",
     ["--spp", "256"], (128, 128), "search_brute", {}, None),
    ("b: 1920x1080, 8 spp, 8 bounces",
     ["-s", "1920", "1080", "--spp", "8", "-b", "8"], (1080, 1920),
     "search_brute", {}, None),
    ("c: as b, --tessellate 3 (640 triangles)",
     ["-s", "1920", "1080", "--spp", "8", "-b", "8", "--tessellate", "3"],
     (1080, 1920), "search_brute", {}, None),
    ("d: 1920x1080, 8 bounces, 2 spp (cut from 8), --tessellate 5 "
     "(10,240 triangles, bitmask)",
     _TESS + ["5"], (1080, 1920), "search_bitmask", {}, None),
    ("e: as d, --tessellate 6 (40,960 triangles, packed resident)",
     _TESS + ["6"], (1080, 1920), "search_packed", {}, None),
    ("f: as d, --tessellate 7 (163,840 triangles, packed streamed)",
     _TESS + ["7"], (1080, 1920), "search_packed", {}, None),
    ("g: as d, RTC_CULL=range (K4, resident range)",
     _TESS + ["5"], (1080, 1920), "search_range", {"RTC_CULL": "range"}, "d"),
    ("h: as f, RTC_CULL=range (K5, streamed range)",
     _TESS + ["7"], (1080, 1920), "search_range", {"RTC_CULL": "range"}, "f"),
    ("i: as e, RTC_STREAM_CULL=words (K6, resident words)",
     _TESS + ["6"], (1080, 1920), "search_words",
     {"RTC_STREAM_CULL": "words"}, "e"),
    ("j: as f, RTC_STREAM_CULL=words (K7, streamed words)",
     _TESS + ["7"], (1080, 1920), "search_words",
     {"RTC_STREAM_CULL": "words"}, "f"),
)
# Plausible band for the tonemapped image's mean byte value: a lit room seen
# from inside (no sky in view), neither black nor blown out.
MEAN_BAND = (60.0, 180.0)

# Phase 5: the port on the card against the port on the CPU. Same tolerance
# as tests/test_torch_render.py: CPU and CUDA libm differ by ulps in log/cos
# (Box-Muller), which can send a ray near an edge down another path.
SMALL = dict(width=32, height=32, spp=4, max_bounce=4)
PIXEL_RTOL = PIXEL_ATOL = 1e-4
MIN_CLOSE_FRAC = 0.995
MAX_MEAN_ABS = 1e-3
MAX_COUNT_REL = 1e-3


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {time.time() - t0:.3f}s {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def random_soup(rng, n_live: int, n_rays: int):
    """Random triangles in front of rays from near the origin; every 7th
    triangle duplicates an earlier one so the lowest-index tie is exercised."""
    import numpy as np

    c = rng.uniform(-6, 6, (n_live, 3)).astype(np.float32)
    c[:, 2] += 10.0
    e1 = (rng.normal(size=(n_live, 3)) * 2.0).astype(np.float32)
    e2 = (rng.normal(size=(n_live, 3)) * 2.0).astype(np.float32)
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    tri = np.concatenate([c, e1, e2, n], axis=1).astype(np.float32)
    dup = np.arange(7, n_live, 7)
    tri[dup] = tri[dup // 2]
    o = (rng.normal(size=(n_rays, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(size=n_rays) >= PHASE3_DEAD
    return tri, o, d, alive


def packet_rays(rng, n_rays: int, lo, hi):
    """Rays in packets of 8 that share an origin region and a direction up
    to a small jitter, as adjacent pixels' rays do; 30% of lanes dead."""
    import numpy as np

    n_pk = -(-n_rays // 8)
    o = np.repeat(rng.uniform(lo, hi, (n_pk, 3)), 8, axis=0)[:n_rays]
    o = (o + rng.normal(size=(n_rays, 3)) * 0.02).astype(np.float32)
    d = np.repeat(rng.normal(size=(n_pk, 3)), 8, axis=0)[:n_rays]
    d = d + rng.normal(size=(n_rays, 3)) * 0.02
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    alive = rng.uniform(size=n_rays) >= PHASE3_DEAD
    return o, d, alive


def packet_scene(rng, kind: str, n_live: int):
    """``(Triangles, n_live, ray origin box)``: a soup of triangles (every
    7th duplicating an earlier one, so that equal distances occur) in a
    12-unit cube, or box_scene tessellated to ``n_live`` triangles."""
    import numpy as np

    from raytracingc_tpu_torch.scene.builder import (
        scene_from_triangles_txt,
        tessellate,
        triangles_from_arrays,
    )

    if kind == "box":
        scene = scene_from_triangles_txt(BOX_SCENE)
        levels = {10 * 4**k: k for k in range(1, 9)}[n_live]
        tris, n = tessellate(scene.triangles, scene.n_triangles, levels=levels)
        return tris, n, ((-5.0, -5.0, -5.0), (5.0, 1.5, 5.0))
    # Edges shrink as the count grows, so that every soup has about the
    # same surface area and most rays hit.
    edge = 0.15 * (163840 / n_live) ** 0.5
    a = rng.uniform(-6, 6, (n_live, 3))
    b = a + rng.normal(size=(n_live, 3)) * edge
    c = a + rng.normal(size=(n_live, 3)) * edge
    verts = np.stack([a, b, c], axis=1).astype(np.float32)
    dup = np.arange(7, n_live, 7)
    verts[dup] = verts[dup // 2]
    nrm = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    nrm[::2] *= -1.0  # both backface-cull outcomes
    tris, n = triangles_from_arrays(
        verts, nrm.astype(np.float32), np.full((n_live, 3), 0.5, np.float32),
        np.zeros(n_live, np.float32), np.zeros(n_live, np.float32))
    return tris, n, ((-8.0, -8.0, -8.0), (8.0, 8.0, 8.0))


@contextlib.contextmanager
def knobs_set(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def check_packet_kernels(dev, rng, cases=PACKET_CASES, rays=PHASE3_RAYS):
    """Phase 3b. Returns ``({label: (kernel ms, plain ms)}, {kernel name:
    max |dst - plain dst|})``; raises on any disagreement."""
    import torch

    from raytracingc_tpu_torch.ops import culling, search
    from raytracingc_tpu_torch.ops.accel import BLOCK, build_accel
    from raytracingc_tpu_torch.ops.search_bitmask import (
        search_bitmask,
        search_bitmask_reference,
    )
    from raytracingc_tpu_torch.ops.search_brute import (
        pack_triangles,
        search_brute_reference,
    )
    from raytracingc_tpu_torch.ops.search_packed import (
        search_packed,
        search_packed_reference,
    )
    from raytracingc_tpu_torch.ops.search_range import (
        search_range,
        search_range_reference,
    )
    from raytracingc_tpu_torch.ops.search_words import (
        search_words,
        search_words_reference,
    )

    routes = {  # route kernel: (wrapper, plain version)
        "bitmask": (search_bitmask, search_bitmask_reference),
        "packed": (search_packed, search_packed_reference),
        "range": (search_range, search_range_reference),
        "words": (search_words, search_words_reference),
    }
    timings = {}
    max_err = {fn.__name__: 0.0 for fn, _ in routes.values()}
    for label, kind, n_live, env, expect in cases:
        t = time.time()
        tris, n, (lo, hi) = packet_scene(rng, kind, n_live)
        tris = tris.to(dev)
        accel = build_accel(tris, n)
        with knobs_set(env):
            way = search.route(n, accel.n_blocks, search.Knobs.read())
        if way.kernel != expect or not label.startswith(way.tpu + " "):
            raise AssertionError(f"{label}: routed to {way}, expected {expect}")
        kern, plain = routes[way.kernel]
        name = kern.__name__
        if way.kernel == "bitmask":
            plane, oi = accel.packed_plane, accel.orig_idx
        else:
            plane, oi = culling.stream_tile_pad(accel.packed_plane,
                                                accel.orig_idx, way.tile)
        brute_tri = pack_triangles(tris, n)
        notes = []
        for n_rays in rays:
            o, d, alive = (torch.from_numpy(x).to(dev)
                           for x in packet_rays(rng, n_rays, lo, hi))
            o_p, d_p, a_p = culling.packets(o, d, alive)
            bpt = way.tile // BLOCK
            if way.kernel == "bitmask":
                words = culling.packet_block_masks(o_p, d_p, a_p, accel)
                args = (o, d, words, plane, oi)
            elif way.kernel == "packed":
                words = culling.packet_tile_words_multi(
                    o_p, d_p, a_p, accel, way.n_tiles, bpt, way.granule)
                args = (o, d, words, plane, oi, way.tile, way.granule)
            elif way.kernel == "words":
                words = culling.packet_tile_words(
                    o_p, d_p, a_p, accel, way.n_tiles, bpt, way.granule)
                args = (o, d, words, plane, oi, way.tile, way.granule)
            else:
                first, last = culling.packet_block_ranges(o_p, d_p, a_p, accel)
                args = (o, d, first, last, plane, oi)
            dk, ik = kern(*args)
            dr, ir = plain(*args)
            db, ib = search_brute_reference(o, d, brute_tri, n, alive)
            torch.cuda.synchronize()
            where = f"{label} R={n_rays}"
            if not torch.equal(ik, ir):
                raise AssertionError(f"{where}: idx differs from the plain "
                                     f"version on {int((ik != ir).sum())} rays")
            if not torch.equal(dk.view(torch.int32), dr.view(torch.int32)):
                raise AssertionError(f"{where}: dst bits differ from the plain version")
            if not (torch.equal(ik[alive], ib[alive]) and torch.equal(
                    dk[alive].view(torch.int32), db[alive].view(torch.int32))):
                raise AssertionError(f"{where}: live lanes differ from the brute "
                                     f"scan on {int((ik != ib)[alive].sum())} rays")
            hits = int((ik[alive] >= 0).sum())
            if hits < n_rays // 100:
                raise AssertionError(f"{where}: only {hits} live rays hit")
            max_err[name] = max(max_err[name], float((dk - dr).abs().max()))
            if way.kernel == "range":
                span = (last - first + 1)[first <= last].float()
                notes.append(f"R={n_rays}: {hits} live hits, {span.numel()} "
                             f"nonempty spans of {span.mean():.1f} blocks on "
                             f"average")
            else:
                notes.append(f"R={n_rays}: {hits} live hits, "
                             f"{int((words != 0).sum())} nonzero words")
            if n_rays == TIMED_RAYS and label in TIMED_PACKET:
                timings[label] = (cuda_ms(lambda: kern(*args), 20),
                                  cuda_ms(lambda: plain(*args),
                                          TIMED_PACKET[label]))
        phase("kernel", t, f"{label}: {name} == plain bitwise, live lanes == "
              f"brute scan; {way.kernel} ({way.tpu}) tile={way.tile} "
              f"n_tiles={way.n_tiles} granule={way.granule}; " + "; ".join(notes))
    return timings, max_err


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(min(3, iters)):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    import numpy as np
    import torch

    t0 = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import raytracingc_tpu_torch
    from raytracingc_tpu_torch import rng as port_rng
    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.cli import main as cli_main
    from raytracingc_tpu_torch.ops import _build
    from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
    from raytracingc_tpu_torch.ops.search_brute import (
        search_brute,
        search_brute_reference,
    )
    from raytracingc_tpu_torch.ops.search_packed import search_packed
    from raytracingc_tpu_torch.ops.search_range import search_range
    from raytracingc_tpu_torch.ops.search_words import search_words
    from raytracingc_tpu_torch.render.image import read_bmp
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    pkg_dir = os.path.dirname(os.path.abspath(raytracingc_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise SystemExit(f"chip_smoke: imported the package from {pkg_dir}, "
                         f"not from this checkout ({HERE})")
    if not os.path.isfile(BOX_SCENE):
        raise SystemExit(f"chip_smoke: {BOX_SCENE} is missing")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # 1. Device.
    phase("device", t0, f"{kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}; "
          f"{torch.cuda.device_count()} visible")

    # 2. Build.
    t = time.time()
    _build.load_library()
    ptxas = "; ".join(
        ln.split(":", 1)[1].strip() for ln in _build.build_log.splitlines()
        if "Used" in ln
    )
    phase("build", t, f"{_build.library_path().name} built in "
          f"{time.time() - t:.2f}s (ptxas: {ptxas or 'cached library'})")

    # 3. Kernel vs plain, on the card: bitwise.
    t = time.time()
    rng = np.random.default_rng(20261016)
    max_abs = 0.0
    n_cases = 0
    timings = {}
    for n_live in PHASE3_N_LIVE:
        for n_rays in PHASE3_RAYS:
            tri, o, d, alive = random_soup(rng, n_live, n_rays)
            args = tuple(torch.from_numpy(x).to(dev) for x in (o, d, tri))
            alive_t = torch.from_numpy(alive).to(dev)
            dk, ik = search_brute(*args, n_live, alive_t)
            dr, ir = search_brute_reference(*args, n_live, alive_t)
            torch.cuda.synchronize()
            if not torch.equal(ik, ir):
                bad = int((ik != ir).sum())
                raise AssertionError(f"n_live={n_live} R={n_rays}: idx differs "
                                     f"on {bad} rays")
            if not torch.equal(dk.view(torch.int32), dr.view(torch.int32)):
                raise AssertionError(f"n_live={n_live} R={n_rays}: dst bits differ")
            if int((ik >= 0).sum()) == 0 and n_live > 1:
                raise AssertionError(f"n_live={n_live} R={n_rays}: no ray hit")
            max_abs = max(max_abs, float((dk - dr).abs().max()))
            n_cases += 1
            if n_rays == TIMED_RAYS and n_live in TIMED_N_LIVE:
                timings[n_live] = (
                    cuda_ms(lambda: search_brute(*args, n_live, alive_t), 50),
                    cuda_ms(lambda: search_brute_reference(*args, n_live, alive_t), 10),
                )
    times = ", ".join(
        f"n_live={n}: kernel {k:.4f} ms, plain {p:.4f} ms"
        for n, (k, p) in sorted(timings.items())
    )
    phase("kernel", t, f"search_brute == search_brute_reference bitwise on "
          f"{n_cases} cases (n_live {PHASE3_N_LIVE} x R {PHASE3_RAYS}, "
          f"{PHASE3_DEAD:.0%} dead); at R={TIMED_RAYS}: {times}")

    # 3b. The packet kernels vs plain, and vs the brute scan.
    t = time.time()
    packet_times, packet_err = check_packet_kernels(dev, rng)
    phase("kernel", t, "packet kernels at R=" + str(TIMED_RAYS) + ": " + ", ".join(
        f"{label}: kernel {k:.4f} ms, plain {p:.4f} ms"
        for label, (k, p) in packet_times.items()))

    # 4. Main path: the CLI in default mode, on the card. Every kernel's
    # count is set to 0 just before each run and read just after it.
    kernels = {"search_brute": search_brute, "search_bitmask": search_bitmask,
               "search_packed": search_packed, "search_range": search_range,
               "search_words": search_words}
    total_launches = dict.fromkeys(kernels, 0)
    traced = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra, shape, expect, env, twin in MAIN_RUNS:
            t = time.time()
            out = os.path.join(tmp, f"main_{label[0]}.bmp")
            for fn in kernels.values():
                fn.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), knobs_set(env):
                rc = cli_main(["--device", "cuda", "--triangles", BOX_SCENE,
                               "-o", out, "--profile", *extra])
            log = buf.getvalue()
            launched = {k: fn.launches for k, fn in kernels.items()}
            for k, v in launched.items():
                total_launches[k] += v
            if rc != 0:
                raise AssertionError(f"{label}: cli exit code {rc}\n{log}")
            prof = re.search(r"render=([0-9.]+)s rays=(\d+)", log)
            if prof is None:
                raise AssertionError(f"{label}: no [profile] line\n{log}")
            render_s, rays = float(prof.group(1)), int(prof.group(2))
            img = read_bmp(out)
            mean = float(img.mean())
            if launched[expect] < 1:
                raise AssertionError(f"{label}: {expect} never launched")
            others = {k: v for k, v in launched.items() if k != expect and v}
            if others:
                raise AssertionError(f"{label}: other kernels launched: {others}")
            if img.shape != (*shape, 3):
                raise AssertionError(f"{label}: image shape {img.shape}")
            if not MEAN_BAND[0] <= mean <= MEAN_BAND[1]:
                raise AssertionError(f"{label}: mean byte {mean:.2f} outside "
                                     f"{MEAN_BAND}")
            if rays <= 0:
                raise AssertionError(f"{label}: no rays traced")
            traced[label[0]] = rays
            same = ""
            if twin is not None:
                with open(out, "rb") as f, open(
                        os.path.join(tmp, f"main_{twin}.bmp"), "rb") as g:
                    if f.read() != g.read():
                        raise AssertionError(f"{label}: BMP differs from ({twin})'s")
                if rays != traced[twin]:
                    raise AssertionError(f"{label}: {rays} traced rays, ({twin}) "
                                         f"traced {traced[twin]}")
                same = f", BMP byte-identical to ({twin})'s, same ray count"
            phase("main", t, f"{label}: render {render_s:.3f}s, {rays} rays, "
                  f"{rays / render_s:.4g} rays/s, {launched[expect]} {expect} "
                  f"launches, mean byte {mean:.2f}{same}")

    # 5. The port on the card vs the port on the CPU.
    t = time.time()
    ids = torch.arange(1 << 20, dtype=torch.int64) * 4093 + (2**32 - (1 << 20) * 4093)
    s_cpu = port_rng.stream_init(7, ids, 2**32 - 3)
    s_gpu = port_rng.stream_init(7, ids.to(dev), 2**32 - 3)
    s_cpu, u_cpu = port_rng.next_uniform(s_cpu)
    s_gpu, u_gpu = port_rng.next_uniform(s_gpu)
    if not (torch.equal(s_cpu, s_gpu.cpu()) and torch.equal(u_cpu, u_gpu.cpu())):
        raise AssertionError("RNG states or uniforms differ between CUDA and CPU")
    scene = scene_from_triangles_txt(BOX_SCENE)
    cam = Camera.look_at()
    img_g, n_g = render(scene, cam, **SMALL, device=dev)
    img_c, n_c = render(scene, cam, **SMALL, device="cpu")
    img_g = img_g.cpu().numpy()
    img_c = img_c.numpy()
    close = np.isclose(img_g, img_c, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    mean_abs = float(np.abs(img_g - img_c).mean())
    if not np.isfinite(img_g).all():
        raise AssertionError("non-finite pixels in the CUDA render")
    if abs(n_g - n_c) > MAX_COUNT_REL * n_c:
        raise AssertionError(f"traced rays: cuda {n_g} vs cpu {n_c}")
    if close.mean() < MIN_CLOSE_FRAC or mean_abs > MAX_MEAN_ABS:
        raise AssertionError(f"cuda vs cpu: {close.mean():.4f} of pixels close, "
                             f"mean |diff| {mean_abs:.3g}")
    phase("cuda_vs_cpu", t, f"RNG bitwise on {ids.numel()} ids; 32x32 4 spp 4 "
          f"bounces: rays cuda {n_g} / cpu {n_c}, {close.mean():.4f} of pixels "
          f"within {PIXEL_RTOL:g}, mean |diff| {mean_abs:.3g}")

    # The kernel line's times are those at the main path's shapes: R =
    # TIMED_RAYS with box_scene at 640 (brute), 10,240 (bitmask) and 163,840
    # (packed, range and words streamed) triangles; the [kernel] lines have
    # the others.
    src = "raytracingc_tpu_torch/csrc/{}.cu"
    tpu = "raytracingc_tpu/ops/intersect_pallas.py:{}"
    rows = [
        ("search_brute", tpu.format(1278), timings[max(TIMED_N_LIVE)], max_abs),
        ("search_bitmask", tpu.format(1453),
         packet_times["K2 box 10,240 (3 words)"], packet_err["search_bitmask"]),
        ("search_packed", tpu.format(869),
         packet_times["K3 box 163,840 streamed"], packet_err["search_packed"]),
        ("search_range", f"{tpu.format(176)} (K4), {tpu.format(350)} (K5)",
         packet_times["K5 box 163,840 streamed (RTC_CULL=range)"],
         packet_err["search_range"]),
        ("search_words", f"{tpu.format(428)} (K6), {tpu.format(598)} (K7)",
         packet_times["K7 box 163,840 streamed (RTC_STREAM_CULL=words)"],
         packet_err["search_words"]),
    ]
    print(nvidia_smi())
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src.format(name),
        "replaces": replaces,
        "launches": total_launches[name],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    } for name, replaces, (k_ms, p_ms), err in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
