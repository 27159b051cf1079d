"""Smoke run of raytracingc_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from this checkout's sources, holds it
against its plain PyTorch version on the card, drives the renderer's main
path through the CLI (the user's entry point), and compares a small render on
the card with the same render on the CPU. Each phase prints one line; any
failure raises and the script exits non-zero without printing a result.

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

# Phase 4: the main path through the CLI, in default mode on box_scene.
# (a) is the CLI's own default workload (128x128, 10 bounces) with spp cut
# from the default 4000 to 256 to bound the run time; (b) and (c) are the
# tracked 1920x1080, 8 spp, 8 bounces configuration, (c) tessellated to 640
# live triangles.
MAIN_RUNS = (
    ("a: 128x128, 10 bounces, 256 spp (CLI defaults, spp cut from 4000)",
     ["--spp", "256"], (128, 128)),
    ("b: 1920x1080, 8 spp, 8 bounces",
     ["-s", "1920", "1080", "--spp", "8", "-b", "8"], (1080, 1920)),
    ("c: as b, --tessellate 3 (640 triangles)",
     ["-s", "1920", "1080", "--spp", "8", "-b", "8", "--tessellate", "3"],
     (1080, 1920)),
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


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
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
    from raytracingc_tpu_torch.ops.search_brute import (
        search_brute,
        search_brute_reference,
    )
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

    # 4. Main path: the CLI in default mode, on the card.
    search_brute.launches = 0
    total_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, extra, shape) in enumerate(MAIN_RUNS):
            t = time.time()
            out = os.path.join(tmp, f"main_{i}.bmp")
            before = search_brute.launches
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["--device", "cuda", "--triangles", BOX_SCENE,
                               "-o", out, "--profile", *extra])
            log = buf.getvalue()
            launched = search_brute.launches - before
            total_launches += launched
            if rc != 0:
                raise AssertionError(f"{label}: cli exit code {rc}\n{log}")
            prof = re.search(r"render=([0-9.]+)s rays=(\d+)", log)
            if prof is None:
                raise AssertionError(f"{label}: no [profile] line\n{log}")
            render_s, rays = float(prof.group(1)), int(prof.group(2))
            img = read_bmp(out)
            mean = float(img.mean())
            if launched < 1:
                raise AssertionError(f"{label}: search_brute never launched")
            if img.shape != (*shape, 3):
                raise AssertionError(f"{label}: image shape {img.shape}")
            if not MEAN_BAND[0] <= mean <= MEAN_BAND[1]:
                raise AssertionError(f"{label}: mean byte {mean:.2f} outside "
                                     f"{MEAN_BAND}")
            if rays <= 0:
                raise AssertionError(f"{label}: no rays traced")
            phase("main", t, f"{label}: render {render_s:.3f}s, {rays} rays, "
                  f"{rays / render_s:.4g} rays/s, {launched} kernel launches, "
                  f"mean byte {mean:.2f}")

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

    # The kernel line's times are those at the main path's largest case
    # (R = TIMED_RAYS, n_live = max(TIMED_N_LIVE)); the [kernel] line has both.
    k_ms, p_ms = timings[max(TIMED_N_LIVE)]
    print(nvidia_smi())
    print(json.dumps({"kernels": [{
        "name": "search_brute",
        "route": "cuda",
        "source": "raytracingc_tpu_torch/csrc/search_brute.cu",
        "replaces": "raytracingc_tpu/ops/intersect_pallas.py:1278",
        "launches": total_launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
