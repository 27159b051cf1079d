"""Smoke run of raytracingc_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from this checkout's sources (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card (bit for bit; the tensor-core MXU kernel within its contract),
drives the renderer's main path through the CLI (the user's entry point) at
every kernel's scene size and under every search knob that picks a kernel,
runs the two measurement tools through their entry points, and compares a
small render on the card with the same render on the CPU. Each phase prints
one line per step; any failure raises and the script exits non-zero without
printing a result.

The last lines are the card's name and power limit as nvidia-smi reports
them, one JSON object describing each kernel (its time, its plain version's,
and its bound: the least time the card could take for the same work), and
the result object ``{"ok": true, "device": {...}}``. Uses only
raytracingc_tpu_torch (no JAX).
"""

from __future__ import annotations

import contextlib
import hashlib
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
# Dead lanes: the share DEAD of raytracingc_tpu_torch/tools/packets.py, in
# every phase.
TIMED_N_LIVE = (10, 640)  # box_scene, and box_scene tessellated 64-fold
TIMED_RAYS = 65536

# Phase 3b: the packet kernels against their plain versions, bit for bit,
# and their live-lane winners against the brute scan over all live
# triangles. (label, scene, live triangles, knobs, expected kernel); the
# scene is a seeded soup or box_scene tessellated to that count, and the
# label starts with the TPU kernel that the route stands for (checked).
# Every case runs coherent packets (tools/packets.py packet_rays), and
# secondary-like packets too (secondary_rays: a shared origin region,
# independent directions, as after a diffuse bounce; they give the range
# kernel wide spans), drawn from their own seeded generator so that the
# coherent rays, and every later case's, are those of the runs before. The
# WHOLE_PLANE cases run wide_span_rays instead, from that generator too:
# every 8th packet's list holds the plane's first and last block (checked;
# for the range kernel, its span is the whole plane), so the range and
# words kernels cut it into the most work items a packet can have, whose
# results meet only in the keys' atomicMin (ties across items:
# tests/test_torch_search_range.py and test_torch_search_words.py, on the
# CPU models). For the range and words cases the count kernel is also held
# to its plain model (range_items, words_items at the source's split) from
# junk-filled buffers, its fill to MISS_KEY and its zeroed counter, and the
# CUDA unpack to unpack_keys, on the keys of the plain version's result.
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
    ("K5 box 163,840 streamed, whole-plane spans (RTC_CULL=range)", "box",
     163840, {"RTC_CULL": "range"}, "range"),
    ("K6 box 40,960 resident (RTC_STREAM_CULL=words)", "box", 40960,
     {"RTC_STREAM_CULL": "words"}, "words"),
    ("K6 box 163,840 streamed (RTC_STREAM_CULL=words RTC_STREAM_ORDER=ray)",
     "box", 163840, {"RTC_STREAM_CULL": "words", "RTC_STREAM_ORDER": "ray"},
     "words"),
    ("K7 box 163,840 streamed (RTC_STREAM_CULL=words)", "box", 163840,
     {"RTC_STREAM_CULL": "words"}, "words"),
    ("K6 box 40,960 resident, whole-plane rays (RTC_STREAM_CULL=words)",
     "box", 40960, {"RTC_STREAM_CULL": "words"}, "words"),
    ("K7 box 163,840 streamed, whole-plane rays (RTC_STREAM_CULL=words)",
     "box", 163840, {"RTC_STREAM_CULL": "words"}, "words"),
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
    "K5 box 163,840 streamed, whole-plane spans (RTC_CULL=range)": 1,
    "K6 box 40,960 resident (RTC_STREAM_CULL=words)": 3,
    "K6 box 163,840 streamed (RTC_STREAM_CULL=words RTC_STREAM_ORDER=ray)": 3,
    "K7 box 163,840 streamed (RTC_STREAM_CULL=words)": 3,
    "K6 box 40,960 resident, whole-plane rays (RTC_STREAM_CULL=words)": 1,
    "K7 box 163,840 streamed, whole-plane rays (RTC_STREAM_CULL=words)": 1,
}
SECONDARY_KERNELS = ("bitmask", "packed", "range", "words")
WHOLE_PLANE = ("K5 box 163,840 streamed, whole-plane spans (RTC_CULL=range)",
               "K6 box 40,960 resident, whole-plane rays (RTC_STREAM_CULL=words)",
               "K7 box 163,840 streamed, whole-plane rays (RTC_STREAM_CULL=words)")
SECONDARY_SEED = 20261017
SECONDARY = " [secondary]"  # label suffix of a case's secondary-like timing

# Phase 3c: the MXU kernel (K8) against its plain version in both
# precisions, its live-lane winners against the brute scan, and the slicing
# check, at R in PHASE3_RAYS with DEAD dead lanes. (label, scene,
# live triangles): box_scene and its tessellations in the kernel's range,
# and a seeded soup at the kernel's cap. The contract (PERF.md): dead lanes
# exactly (MISS_DST, -1); winners equal except flips at a validity boundary
# (f64 margin < MXU_FLIP_MARGIN of one of the two triangles) on at most
# MXU_MAX_FLIP_FRAC of the live lanes; distances of agreeing hits within
# MXU_DST_RTOL of the plain version's, or, on a grazing hit, within
# MXU_DET_EPS times det's condition number kappa = sum_j |d_j n_j| / |d.n|
# (n = AC x AB), kappa capped at MXU_KAPPA_CAP: t' is the same bits in both,
# and det's two sums of the same terms in another order differ by a few
# roundings of the largest term; against the brute scan, highest equal on
# the soup; K8 on R rays equal to K8 on two halves bit for bit. The control:
# the 2-part (split3) kernel held to highest's plain version must break the
# contract, on grazing lanes too (split3 drops ~2^-16 of each term).
MXU_CASES = (
    ("box 10 (1 block)", "box", 10),
    ("box 640 (--tessellate 3)", "box", 640),
    ("box 2,560 (--tessellate 4)", "box", 2560),
    ("soup 8,192 (64 blocks, 3 words)", "soup", 8192),
)
MXU_TIMED = "box 640 (--tessellate 3)"  # the scene of main-path run (k)
MXU_FLIP_MARGIN = 1e-3
MXU_MAX_FLIP_FRAC = 0.005
MXU_DST_RTOL = 1e-5
MXU_DET_EPS = 2.0**-20  # 16 roundings at 2^-24
MXU_KAPPA_CAP = 128.0  # the distance bound never passes 2^-13 (1.22e-4)
MXU_CONTROL = "soup 8,192 (64 blocks, 3 words)"  # the case with grazing hits
MXU_PLAIN_CHUNK = 64  # (program, block) pairs per step of the plain version

# Phase 3d: the union-walk kernel (K9) against its plain version and, on
# live lanes, the default route (K2), bit for bit; timed beside K2 (and K8
# where the scene fits it) on the same rays.
UNION_CASES = (
    ("box 2,560 (--tessellate 4)", "box", 2560),
    ("box 10,240 (--tessellate 5)", "box", 10240),
)
UNION_TIMED = "box 10,240 (--tessellate 5)"  # the union tool's scene

# Bounds: the larger of the operations over the card's peak rate for their
# type and the bytes over its memory rate (H100 SXM at 700 W). FP32
# operations of one MT test (csrc/mt.cuh mt_distance, each add, multiply,
# compare, abs and select and the IEEE division counted as one): dn 5, h 9,
# det 5, the guard 2, the guarded 1/det 2, s 3, u 6, q 9, v 6, dst 6, the
# validity tests 7, the result select 1. The kernels are built with
# --fmad=false (bit equality with the plain versions), so no multiply and add
# fuse: each operation is its own instruction, and the FP32 rate is one
# operation per lane per clock, 132 SMs x 128 lanes x 1.98 GHz = 33.4e12/s,
# not the published 67 TFLOP/s, which counts an FMA as two.
PEAK_FP32 = 33.4e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
MT_OPS = 61
# K8's CUDA-core work per pair (csrc/search_mxu.cu mxu_test): t' 7, the
# guard 2, 1/det 2, u, v, dst 3, the validity tests 7; and its tensor-core
# FLOPs per pair: 2 x the non-zero coefficients of the four planes (det 3,
# dn 3, u' 9, v' 9 of pack_coeffs_mxu's 16 columns; the kernel's products
# also cover the structural zeros, 4 x 16) x the bf16 products per plane.
MXU_EPILOGUE_OPS = 21
MXU_MACS = 24
MXU_PRODUCTS = {"split3": 3, "highest": 6}
RPP = 1024 * 128  # ray-triangle pairs of one (program, block) pair

# Phase 4: the main path through the CLI, in default mode on box_scene.
# (a) is the CLI's own default workload (128x128, 10 bounces) with spp cut
# from the default 4000 to 256 to bound the run time; (b) and (c) are the
# tracked 1920x1080, 8 spp, 8 bounces configuration, (c) tessellated to 640
# live triangles; (d)-(f) tessellate box_scene past the brute kernel's
# range, one run per packet route, at 1920x1080 and 8 bounces with spp cut
# from 8 to 2 to bound the run time. (g)-(j) are the A/B culling routes, with
# the flags of (d)-(f), under the RTC_* knobs their users set: each must
# write a BMP byte-identical to its default-route twin's and trace as many
# rays. (k)-(n) are the MXU route (RTC_KERNEL=mxu, opt-in as in the JAX
# package) at 640 and 2,560 triangles and (m) the bitmask route it is held
# against at 2,560; the MXU's distances differ from the f32 search's by up
# to ~2e-4 relative and split3 flips razor-edge winners, so (k), (l) and (n)
# are held to their twins at a tolerance: traced rays within
# TWIN_RAYS_REL, mean byte within TWIN_MEAN_ABS. (label, flags, image shape,
# kernel, knobs, twin, twin equal byte for byte).
_TESS = ["-s", "1920", "1080", "--spp", "2", "-b", "8", "--tessellate"]
_FULL = ["-s", "1920", "1080", "--spp", "8", "-b", "8", "--tessellate"]
TWIN_RAYS_REL = 1e-3
TWIN_MEAN_ABS = 0.5
MAIN_RUNS = (
    ("a: 128x128, 10 bounces, 256 spp (CLI defaults, spp cut from 4000)",
     ["--spp", "256"], (128, 128), "search_brute", {}, None, True),
    ("b: 1920x1080, 8 spp, 8 bounces",
     ["-s", "1920", "1080", "--spp", "8", "-b", "8"], (1080, 1920),
     "search_brute", {}, None, True),
    ("c: as b, --tessellate 3 (640 triangles)",
     _FULL + ["3"], (1080, 1920), "search_brute", {}, None, True),
    ("d: 1920x1080, 8 bounces, 2 spp (cut from 8), --tessellate 5 "
     "(10,240 triangles, bitmask)",
     _TESS + ["5"], (1080, 1920), "search_bitmask", {}, None, True),
    ("e: as d, --tessellate 6 (40,960 triangles, packed resident)",
     _TESS + ["6"], (1080, 1920), "search_packed", {}, None, True),
    ("f: as d, --tessellate 7 (163,840 triangles, packed streamed)",
     _TESS + ["7"], (1080, 1920), "search_packed", {}, None, True),
    ("g: as d, RTC_CULL=range (K4, resident range)",
     _TESS + ["5"], (1080, 1920), "search_range", {"RTC_CULL": "range"}, "d",
     True),
    ("h: as f, RTC_CULL=range (K5, streamed range)",
     _TESS + ["7"], (1080, 1920), "search_range", {"RTC_CULL": "range"}, "f",
     True),
    ("i: as e, RTC_STREAM_CULL=words (K6, resident words)",
     _TESS + ["6"], (1080, 1920), "search_words",
     {"RTC_STREAM_CULL": "words"}, "e", True),
    ("j: as f, RTC_STREAM_CULL=words (K7, streamed words)",
     _TESS + ["7"], (1080, 1920), "search_words",
     {"RTC_STREAM_CULL": "words"}, "f", True),
    ("k: as c, RTC_KERNEL=mxu (K8, split3)",
     _FULL + ["3"], (1080, 1920), "search_mxu", {"RTC_KERNEL": "mxu"}, "c",
     False),
    ("l: as c, RTC_KERNEL=mxu RTC_MXU_PRECISION=highest (K8, highest)",
     _FULL + ["3"], (1080, 1920), "search_mxu",
     {"RTC_KERNEL": "mxu", "RTC_MXU_PRECISION": "highest"}, "c", False),
    ("m: 1920x1080, 8 spp, 8 bounces, --tessellate 4 (2,560 triangles, "
     "bitmask)",
     _FULL + ["4"], (1080, 1920), "search_bitmask", {}, None, True),
    ("n: as m, RTC_KERNEL=mxu (K8, split3)",
     _FULL + ["4"], (1080, 1920), "search_mxu", {"RTC_KERNEL": "mxu"}, "m",
     False),
)
# The two measurement tools, through their entry points: (label, module
# under raytracingc_tpu_torch.tools, arguments, kernel). The union tool runs
# its checks only (--iters 0; phase 3d times K9), so that its launches count
# the workloads, not a timing loop.
TOOL_RUNS = (
    ("o: union_walk_ab (K9 vs K2; box_scene 10,240 triangles, 1920x1080 "
     "frame, 262,144 rays per workload, checks only)", "union_walk_ab",
     ["--device", "cuda", "--iters", "0"], "search_union"),
    ("p: smem_probe (K10, the shared-memory ladder)", "smem_probe",
     ["--device", "cuda"], "smem_probe"),
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

    from raytracingc_tpu_torch.tools.packets import DEAD

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
    alive = rng.uniform(size=n_rays) >= DEAD
    return tri, o, d, alive


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
        levels = {10 * 4**k: k for k in range(9)}[n_live]
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


def check_packet_kernels(dev, rng, cases=PACKET_CASES, rays=PHASE3_RAYS):
    """Phase 3b. Returns ``({label: (kernel ms, plain ms)}, {kernel name:
    max |dst - plain dst|}, {label: (tested pairs, bytes)})``, the last two
    at R = TIMED_RAYS; raises on any disagreement."""
    import torch

    from raytracingc_tpu_torch.ops import culling, search
    from raytracingc_tpu_torch.ops.accel import BLOCK, build_accel
    from raytracingc_tpu_torch.ops.search_bitmask import (
        bitmask_table,
        n_packets,
        search_bitmask,
        search_bitmask_reference,
    )
    from raytracingc_tpu_torch.ops.search_brute import (
        pack_triangles,
        search_brute_reference,
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
    from raytracingc_tpu_torch.ops.search_words import (
        search_words,
        search_words_reference,
    )
    from raytracingc_tpu_torch.tools import cuda_ms, knobs_set
    from raytracingc_tpu_torch.tools.packets import (
        packet_rays,
        secondary_rays,
        wide_span_rays,
    )

    import numpy as np

    routes = {  # route kernel: (wrapper, plain version)
        "bitmask": (search_bitmask, search_bitmask_reference),
        "packed": (search_packed, search_packed_reference),
        "range": (search_range, search_range_reference),
        "words": (search_words, search_words_reference),
    }
    timings = {}
    work = {}
    max_err = {fn.__name__: 0.0 for fn, _ in routes.values()}
    for case, (label, kind, n_live, env, expect) in enumerate(cases):
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
        sec_rng = np.random.default_rng([SECONDARY_SEED, case])
        ray_sets = [("", lambda n_rays: packet_rays(rng, n_rays, lo, hi))]
        if label in WHOLE_PLANE:
            ray_sets = [("", lambda n_rays: wide_span_rays(sec_rng, n_rays, lo,
                                                           hi, accel))]
        elif way.kernel in SECONDARY_KERNELS:
            ray_sets.append((SECONDARY, lambda n_rays: secondary_rays(
                sec_rng, n_rays, lo, hi)))
        notes = []
        for n_rays, (suffix, make) in ((r, s) for r in rays for s in ray_sets):
            o, d, alive = (torch.from_numpy(x).to(dev) for x in make(n_rays))
            o_p, d_p, a_p = culling.packets(o, d, alive)
            bpt = way.tile // BLOCK
            if way.kernel == "bitmask":
                words = culling.packet_block_masks(o_p, d_p, a_p, accel)
                args = (o, d, words, plane, oi)
                table = bitmask_table(words, accel.n_blocks)
            elif way.kernel == "packed":
                words = culling.packet_tile_words_multi(
                    o_p, d_p, a_p, accel, way.n_tiles, bpt, way.granule)
                args = (o, d, words, plane, oi, way.tile, way.granule)
                table = packed_table(words, bpt, way.granule)
            elif way.kernel == "words":
                words = culling.packet_tile_words(
                    o_p, d_p, a_p, accel, way.n_tiles, bpt, way.granule)
                args = (o, d, words, plane, oi, way.tile, way.granule)
                table = packed_table(words[..., None], bpt, way.granule)
            else:
                first, last = culling.packet_block_ranges(o_p, d_p, a_p, accel)
                args = (o, d, first, last, plane, oi)
                table = range_table(first, last, plane.shape[1] // BLOCK)
            dk, ik = kern(*args)
            dr, ir = plain(*args)
            db, ib = search_brute_reference(o, d, brute_tri, n, alive)
            torch.cuda.synchronize()
            where = f"{label}{suffix} R={n_rays}"
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
            if way.kernel in ("range", "words"):
                n_items = check_item_launches(way.kernel, args, (dr, ir), where)
                ends = int((table[:, 0] & table[:, accel.n_blocks - 1]).sum())
                if label in WHOLE_PLANE and ends < n_packets(n_rays) // 16:
                    raise AssertionError(f"{where}: only {ends} packets hold the "
                                         f"first and the last block")
                walk = table.sum(1)[table.any(1)].float()
                notes.append(f"R={n_rays}{suffix}: {hits} live hits, "
                             f"{walk.numel()} packets walk {walk.mean():.1f} blocks "
                             f"on average in {n_items} work items, {ends} hold the "
                             f"first and the last block ({accel.n_blocks} blocks)")
            else:
                notes.append(f"R={n_rays}{suffix}: {hits} live hits, "
                             f"{int((words != 0).sum())} nonzero words, "
                             f"{int(table.sum())} (packet, block) pairs")
            if n_rays == TIMED_RAYS and label in TIMED_PACKET:
                timings[label + suffix] = (cuda_ms(lambda: kern(*args), 20),
                                           cuda_ms(lambda: plain(*args),
                                                   TIMED_PACKET[label]))
                work[label + suffix] = (
                    int(table.sum()) * culling.RAY_SUBLANES * BLOCK,
                    n_bytes(*args[:-2 if way.kernel in ("packed", "words")
                                  else None], dk, ik))
        phase("kernel", t, f"{label}: {name} == plain bitwise, live lanes == "
              f"brute scan; {way.kernel} ({way.tpu}) tile={way.tile} "
              f"n_tiles={way.n_tiles} granule={way.granule}; " + "; ".join(notes))
    return timings, max_err, work


def check_item_launches(kernel, args, plain, where) -> int:
    """The range or words search's count kernel on this case's inputs, from
    junk-filled buffers: its item counts equal the plain model's at the
    source's split (range_items, words_items), its keys the packed miss
    MISS_KEY and its claim counter 0; and the CUDA unpack equals
    unpack_keys, and the plain result, on that result's keys. Returns the
    item count; raises on any difference."""
    import ctypes

    import torch

    from raytracingc_tpu_torch.ops import _build, search_range, search_words
    from raytracingc_tpu_torch.ops.accel import BLOCK
    from raytracingc_tpu_torch.ops.search_bitmask import n_packets

    lib = _build.load_library()
    o = args[0]
    r = o.shape[0]
    items = torch.full((n_packets(r),), -5, dtype=torch.int32, device=o.device)
    counter = torch.full((1,), 12345, dtype=torch.int64, device=o.device)
    keys = torch.full((r,), -7, dtype=torch.int64, device=o.device)
    bufs = (items.data_ptr(), counter.data_ptr(), keys.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    if kernel == "range":
        _, _, first, last, plane, _ = args
        n_blocks = plane.shape[1] // BLOCK
        code = lib.rtc_range_items(first.data_ptr(), last.data_ptr(), ctypes.c_int(r),
                                   ctypes.c_int(n_blocks), *bufs)
        want = search_range.range_items(first, last, n_blocks, search_range.SPLIT)
    else:
        _, _, words, _, _, tile, granule = args
        code = lib.rtc_words_items(
            words.data_ptr(), ctypes.c_int(r), *(ctypes.c_int(x) for x in (
                words.shape[1], tile // BLOCK, granule)), *bufs)
        want = search_words.words_items(words, tile // BLOCK, granule,
                                        search_words.SPLIT)
    _build.check(code, f"{kernel} items launch")
    torch.cuda.synchronize()
    if not torch.equal(items, want):
        raise AssertionError(f"{where}: the {kernel} count kernel differs from its "
                             f"plain model on {int((items != want).sum())} packets")
    if not ((keys == search_range.MISS_KEY).all() and int(counter) == 0):
        raise AssertionError(f"{where}: the {kernel} count kernel left keys other "
                             f"than MISS_KEY or a counter other than 0")
    dr, ir = plain
    packed = torch.where(ir >= 0, search_range.pack_keys(dr, ir.clamp(min=0)),
                         search_range.MISS_KEY)
    got = search_range.unpack_keys_cuda(packed)
    for want_d, want_i in (search_range.unpack_keys(packed), plain):
        if not (torch.equal(got[1], want_i) and torch.equal(
                got[0].view(torch.int32), want_d.view(torch.int32))):
            raise AssertionError(f"{where}: the CUDA unpack differs from "
                                 f"unpack_keys or from the plain result")
    return int(items.sum())


def n_bytes(*tensors) -> int:
    """Bytes of the tensors, each read (or written) once."""
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(ops: float = 0.0, tc_flops: float = 0.0, nbytes: float = 0.0):
    """``(ms, "operations" or "bytes")``: the least time the card could take
    for FP32 ``ops``, bf16 tensor-core ``tc_flops`` and ``nbytes`` moved."""
    t_ops = max(ops / PEAK_FP32, tc_flops / PEAK_BF16)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def boundary_margin(tris, o, d, idx):
    """For each ray, the f64 distance of triangle ``idx`` (original order,
    >= 0) from its nearest barycentric validity boundary (u, v, 1 - u - v),
    as tests/test_intersect_mxu.py measures it: tiny means a razor-edge case
    that any rounding can flip."""
    import torch

    t = idx.long()
    a, b, c = (x[t].double() for x in (tris.a, tris.b, tris.c))
    o, d = o.double(), d.double()
    ab, ac = b - a, c - a
    h = torch.linalg.cross(d, ac)
    det = (ab * h).sum(-1)
    s = o - a
    u = (s * h).sum(-1) / det
    v = (d * torch.linalg.cross(s, ab)).sum(-1) / det
    m = torch.stack([u.abs(), (1 - u).abs(), v.abs(), (u + v - 1).abs()]).amin(0)
    return torch.where(det.abs() < 1e-12, 0.0, m)


def det_condition(tris, d, idx):
    """For each ray, kappa = sum_j |d_j n_j| / |d . n| of triangle ``idx``
    (original order, >= 0), n = AC x AB, in f64: how far det cancels."""
    import torch

    t = idx.long()
    a, b, c = (x[t].double() for x in (tris.a, tris.b, tris.c))
    terms = d.double() * torch.linalg.cross(c - a, b - a)
    return terms.abs().sum(-1) / terms.sum(-1).abs()


def winner_flips(tris, o, d, live, ia, ib):
    """``(flips, flips not at a boundary)`` among the live lanes where the
    winners ``ia`` and ``ib`` differ: a flip is at a boundary when one of
    the two triangles has a margin below MXU_FLIP_MARGIN."""
    import torch

    lanes = torch.nonzero(live & (ia != ib)).flatten()
    if lanes.numel() == 0:
        return 0, 0
    oo, dd = o[lanes], d[lanes]
    margin = torch.full((lanes.numel(),), float("inf"), dtype=torch.float64,
                        device=o.device)
    for ix in (ia[lanes], ib[lanes]):
        m = boundary_margin(tris, oo, dd, ix.clamp_min(0))
        margin = torch.minimum(margin, torch.where(ix >= 0, m, float("inf")))
    return lanes.numel(), int((margin >= MXU_FLIP_MARGIN).sum())


def mxu_contract(tris, o, d, alive, got, want) -> dict:
    """``got = (dst, idx)`` against ``want`` under phase 3c's contract:
    winner flips (and those off a validity boundary), agreeing live hits,
    hits past the distance bound (and how many of them are grazing: kappa
    widens their bound past MXU_DST_RTOL), hits admitted by the kappa term
    alone, the worst relative distance error and its lane's kappa, the
    largest kappa, the largest |ddst|, and ``ok``."""
    import torch

    (dk, ik), (dr, ir) = got, want
    flips, bad = winner_flips(tris, o, d, alive, ik, ir)
    agree = alive & (ik == ir) & (ik >= 0)
    err = (dk - dr).abs()[agree]
    rel = err / dr.abs()[agree]
    kappa = det_condition(tris, d[agree], ik[agree])
    wide = torch.clamp(kappa, max=MXU_KAPPA_CAP) * MXU_DET_EPS
    over = rel > torch.clamp(wide, min=MXU_DST_RTOL)
    graze = wide > MXU_DST_RTOL
    worst = int(rel.argmax()) if rel.numel() else None
    pick = lambda x: float(x[worst]) if worst is not None else 0.0
    return {
        "flips": flips, "bad": bad, "hits": int(agree.sum()),
        "over": int(over.sum()), "graze": int(graze.sum()),
        "graze_over": int((over & graze).sum()),
        "kappa_only": int(((rel > MXU_DST_RTOL) & ~over).sum()),
        "rel": pick(rel), "rel_kappa": pick(kappa),
        "kappa_max": float(kappa.max()) if worst is not None else 0.0,
        "abs": float(err.max()) if worst is not None else 0.0,
        "ok": (not bad and flips <= MXU_MAX_FLIP_FRAC * int(alive.sum())
               and not over.any()),
    }


def contract_note(c: dict) -> str:
    return (f"flips {c['flips']} ({c['bad']} off a boundary), max |ddst| "
            f"{c['abs']:.3g}, worst rel {c['rel']:.3g} at kappa "
            f"{c['rel_kappa']:.4g}, max kappa {c['kappa_max']:.4g}, "
            f"{c['over']} of {c['hits']} hits past the bound "
            f"({c['graze_over']} of {c['graze']} grazing), {c['kappa_only']} "
            f"admitted by the kappa term alone")


def check_mxu_kernel(dev, rng, cases=MXU_CASES, rays=PHASE3_RAYS):
    """Phase 3c. Returns ``({label: {precision: (kernel ms, plain ms)}},
    max |dst - plain dst| over agreeing live hits, {label: (tested
    (program, block) pairs, bytes)})``, at R = TIMED_RAYS; raises on a
    broken contract or on a control that passes."""
    import torch

    from raytracingc_tpu_torch.ops import culling, search
    from raytracingc_tpu_torch.ops.accel import build_accel
    from raytracingc_tpu_torch.ops.intersect_mxu import (
        PRECISIONS,
        search_mxu,
        search_mxu_reference,
    )
    from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table
    from raytracingc_tpu_torch.ops.search_brute import (
        pack_triangles,
        search_brute_reference,
    )
    from raytracingc_tpu_torch.scene.types import MISS_DST
    from raytracingc_tpu_torch.tools import cuda_ms, knobs_set
    from raytracingc_tpu_torch.tools.packets import packet_rays

    timings, work, max_err, control = {}, {}, 0.0, None
    for label, kind, n_live in cases:
        t = time.time()
        tris, n, (lo, hi) = packet_scene(rng, kind, n_live)
        tris = tris.to(dev)
        accel = build_accel(tris, n)
        with knobs_set({"RTC_KERNEL": "mxu"}):
            way = search.route(n, accel.n_blocks, search.Knobs.read())
        if way.kernel != "mxu" or accel.mxu_coeffs is None:
            raise AssertionError(f"{label}: routed to {way}, expected mxu")
        coeffs, oi = accel.mxu_coeffs, accel.orig_idx
        brute_tri = pack_triangles(tris, n)
        notes = []
        for n_rays in rays:
            o, d, alive = (torch.from_numpy(x).to(dev)
                           for x in packet_rays(rng, n_rays, lo, hi))
            o_p, d_p, a_p = culling.packets(o, d, alive)
            words, flags = culling.program_union_words(o_p, d_p, a_p, accel)
            blocks = int(bitmask_table(words, accel.n_blocks).sum())
            pk_blocks = int(bitmask_table(
                culling.packet_block_masks(o_p, d_p, a_p, accel),
                accel.n_blocks).sum())
            db, ib = search_brute_reference(o, d, brute_tri, n, alive)
            live = int(alive.sum())
            where = f"{label} R={n_rays}"
            outs = {}
            for prec in PRECISIONS:
                args = (o, d, words, flags, coeffs, oi, prec, alive)
                dk, ik = search_mxu(*args)
                dr, ir = search_mxu_reference(*args, chunk=MXU_PLAIN_CHUNK)
                torch.cuda.synchronize()
                for who, (dx, ix) in (("kernel", (dk, ik)), ("plain", (dr, ir))):
                    if not ((ix[~alive] == -1).all()
                            and (dx[~alive] == MISS_DST).all()):
                        raise AssertionError(f"{where} {prec}: {who} dead lanes "
                                             f"are not (MISS_DST, -1)")
                outs[prec] = ((dk, ik), (dr, ir))
                c = mxu_contract(tris, o, d, alive, (dk, ik), (dr, ir))
                if not c["ok"]:
                    raise AssertionError(f"{where} {prec}: out of contract against "
                                         f"the plain version: {contract_note(c)}")
                max_err = max(max_err, c["abs"])
                b_flips, b_bad = winner_flips(tris, o, d, alive, ik, ib)
                exact = prec == "highest" and kind == "soup"
                if (b_flips if exact else b_bad) or b_flips > MXU_MAX_FLIP_FRAC * live:
                    raise AssertionError(f"{where} {prec}: {b_flips} winner flips "
                                         f"against the brute scan, {b_bad} not at "
                                         f"a validity boundary")
                hits = int((ik[alive] >= 0).sum())
                if hits < n_rays // 100:
                    raise AssertionError(f"{where}: only {hits} live rays hit")
                half = -(-(n_rays // 2) // 1024) * 1024
                parts = []
                for sl in (slice(0, half), slice(half, None)):
                    w2, f2 = culling.program_union_words(
                        *culling.packets(o[sl], d[sl], alive[sl]), accel)
                    parts.append(search_mxu(o[sl], d[sl], w2, f2, coeffs, oi,
                                            prec, alive[sl]))
                if not (torch.equal(torch.cat([p[1] for p in parts]), ik)
                        and torch.equal(torch.cat([p[0] for p in parts]).view(
                            torch.int32), dk.view(torch.int32))):
                    raise AssertionError(f"{where} {prec}: two halves differ from "
                                         f"one call")
                notes.append(f"R={n_rays} {prec}: {hits} live hits; vs plain: "
                             f"{contract_note(c)}; vs brute: {b_flips} flips "
                             f"({b_bad} off a boundary)")
                if n_rays == TIMED_RAYS and (prec == "split3" or label == MXU_TIMED):
                    timings.setdefault(label, {})[prec] = (
                        cuda_ms(lambda: search_mxu(*args), 20),
                        cuda_ms(lambda: search_mxu_reference(
                            *args, chunk=MXU_PLAIN_CHUNK), 2))
                    work[label] = (blocks, n_bytes(o, d, alive, words, flags,
                                                   coeffs, oi, dk, ik))
            if n_rays == TIMED_RAYS and label == MXU_CONTROL:
                control = mxu_contract(tris, o, d, alive, outs["split3"][0],
                                       outs["highest"][1])
                if control["ok"] or not control["graze_over"]:
                    raise AssertionError(f"{where}: the control (split3 kernel "
                                         f"held to highest's plain version) is "
                                         f"not caught on grazing lanes: "
                                         f"{contract_note(control)}")
                notes.append(f"R={n_rays} control, split3 kernel held to "
                             f"highest's plain version: out of contract as it "
                             f"must be: {contract_note(control)}")
            notes.append(f"R={n_rays}: {blocks} (program, block) pairs, "
                         f"{blocks * 1024 * 128} ray-triangle pairs against "
                         f"{pk_blocks * 8 * 128} per packet "
                         f"({blocks * 128 / max(pk_blocks, 1):.3f}x)")
        phase("kernel", t, f"{label}: search_mxu vs plain and brute inside the "
              f"contract, halves == one call; " + "; ".join(notes))
    if control is None:
        raise AssertionError(f"phase 3c ran no control ({MXU_CONTROL!r})")
    return timings, max_err, work


def check_union_kernel(dev, rng, cases=UNION_CASES, rays=PHASE3_RAYS):
    """Phase 3d. Returns ``({label: {kernel: ms}}, max |dst - plain dst|,
    {label: (tested (program, block) pairs, bytes)})``, at R = TIMED_RAYS;
    raises on any disagreement."""
    import torch

    from raytracingc_tpu_torch.ops import culling, search
    from raytracingc_tpu_torch.ops.accel import build_accel
    from raytracingc_tpu_torch.ops.intersect_mxu import search_mxu
    from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table, search_bitmask
    from raytracingc_tpu_torch.ops.search_union import (
        search_union,
        search_union_reference,
    )
    from raytracingc_tpu_torch.tools import cuda_ms
    from raytracingc_tpu_torch.tools.packets import packet_rays

    timings, work, max_err = {}, {}, 0.0
    for label, kind, n_live in cases:
        t = time.time()
        tris, n, (lo, hi) = packet_scene(rng, kind, n_live)
        tris = tris.to(dev)
        accel = build_accel(tris, n)
        plane, oi = accel.packed_plane, accel.orig_idx
        notes = []
        for n_rays in rays:
            o, d, alive = (torch.from_numpy(x).to(dev)
                           for x in packet_rays(rng, n_rays, lo, hi))
            o_p, d_p, a_p = culling.packets(o, d, alive)
            words, flags = culling.program_union_words(o_p, d_p, a_p, accel)
            pk_words = culling.packet_block_masks(o_p, d_p, a_p, accel)
            args = (o, d, words, flags, plane, oi)
            dk, ik = search_union(*args)
            dr, ir = search_union_reference(*args)
            dp, ip_ = search.search_triangles(o, d, tris, n, alive=alive,
                                              accel=accel)
            torch.cuda.synchronize()
            where = f"{label} R={n_rays}"
            if not (torch.equal(ik, ir)
                    and torch.equal(dk.view(torch.int32), dr.view(torch.int32))):
                raise AssertionError(f"{where}: search_union differs from its "
                                     f"plain version on {int((ik != ir).sum())} rays")
            if not (torch.equal(ik[alive], ip_[alive]) and torch.equal(
                    dk[alive].view(torch.int32), dp[alive].view(torch.int32))):
                raise AssertionError(f"{where}: live lanes differ from the default "
                                     f"route on {int((ik != ip_)[alive].sum())} rays")
            max_err = max(max_err, float((dk - dr).abs().max()))
            blocks = int(bitmask_table(words, accel.n_blocks).sum())
            pk_blocks = int(bitmask_table(pk_words, accel.n_blocks).sum())
            notes.append(f"R={n_rays}: {int((ik[alive] >= 0).sum())} live hits, "
                         f"{blocks} (program, block) pairs = {blocks * 1024 * 128} "
                         f"ray-triangle pairs against {pk_blocks * 8 * 128} per "
                         f"packet ({blocks * 128 / max(pk_blocks, 1):.3f}x)")
            if n_rays == TIMED_RAYS:
                ms = {"search_union": cuda_ms(lambda: search_union(*args), 20),
                      "search_union plain": cuda_ms(
                          lambda: search_union_reference(*args), 2),
                      "search_bitmask": cuda_ms(lambda: search_bitmask(
                          o, d, pk_words, plane, oi), 20)}
                if accel.mxu_coeffs is not None:
                    for prec in ("split3", "highest"):
                        ms[f"search_mxu {prec}"] = cuda_ms(lambda: search_mxu(
                            o, d, words, flags, accel.mxu_coeffs, oi, prec,
                            alive), 20)
                timings[label] = ms
                work[label] = (blocks, n_bytes(o, d, words, flags, plane, oi, dk, ik))
                pairs = lambda k: (pk_blocks * 8 if k == "search_bitmask"
                                   else blocks * 1024) * 128
                notes.append(f"at R={n_rays}: " + ", ".join(
                    f"{k} {v:.4f} ms ({v * 1e6 / pairs(k):.4f} ns per tested pair)"
                    for k, v in ms.items()))
        phase("kernel", t, f"{label}: search_union == plain bitwise, live lanes == "
              f"default route ({search.route(n, accel.n_blocks, search.Knobs.read()).kernel}); "
              + "; ".join(notes))
    return timings, max_err, work


def check_smem_probe(dev):
    """Phase 3e: every ladder size up to the device's opt-in limit runs and
    equals the plain version bit for bit; the first size past it is refused
    by the launch with cudaErrorInvalidValue. Returns ``(limit bytes,
    kernel ms, plain ms, (operations, bytes) the function needs)`` at the
    limit and the ladder's ``(n, equal, refusal)``."""
    import torch

    from raytracingc_tpu_torch.tools import cuda_ms
    from raytracingc_tpu_torch.tools import smem_probe as sp

    limit = sp.optin_bytes(dev)
    sizes = sp.ladder(limit)
    results = sp.run_ladder(dev, sizes)
    fits = [n for n in sizes if n * 4 <= limit]
    want = fits + [next(n for n in sizes if n * 4 > limit)]
    if [n for n, _, _ in results] != want:
        raise AssertionError(f"smem_probe ran {[n for n, _, _ in results]}, "
                             f"expected {want}")
    for n, equal, err in results:
        if n * 4 <= limit and (err is not None or not equal):
            raise AssertionError(f"smem_probe n={n}: {err or 'differs from plain'}")
        if n * 4 > limit and (err is None or err.code != sp.CUDA_ERROR_INVALID_VALUE):
            raise AssertionError(f"smem_probe n={n} past the limit: {err!r}")
    n = limit // 4
    sm = torch.arange(n, dtype=torch.int32, device=dev)
    x = torch.ones(sp.X_SHAPE, dtype=torch.float32, device=dev)
    out = sp.smem_probe(sm, x)
    # Per tile of x: three table words read, two int adds and a conversion;
    # per element of x: one add.
    tiles = x.shape[0] // sp.TILE_ROWS
    work = (x.numel() + 3 * tiles, n_bytes(x, out) + 3 * 4 * tiles)
    return (limit, cuda_ms(lambda: sp.smem_probe(sm, x), 50),
            cuda_ms(lambda: sp.smem_probe_reference(sm, x), 50), work, results)


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
    from raytracingc_tpu_torch import tools
    from raytracingc_tpu_torch.tools import cuda_ms, knobs_set
    from raytracingc_tpu_torch.ops import _build
    from raytracingc_tpu_torch.ops.intersect_mxu import search_mxu
    from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
    from raytracingc_tpu_torch.ops.search_brute import (
        search_brute,
        search_brute_reference,
    )
    from raytracingc_tpu_torch.ops.search_packed import search_packed
    from raytracingc_tpu_torch.ops.search_range import search_grid as item_grid
    from raytracingc_tpu_torch.ops.search_range import search_range
    from raytracingc_tpu_torch.ops.search_union import search_union
    from raytracingc_tpu_torch.ops.search_words import search_words
    from raytracingc_tpu_torch.render.image import read_bmp
    from raytracingc_tpu_torch.tools import smem_probe, union_walk_ab
    from raytracingc_tpu_torch.tools.packets import DEAD
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
    packet_ptxas = "; ".join(
        f"{k}: {_build.ptxas_report(k) or 'not reported'}"
        for k in ("search_bitmask_kernel", "search_packed_kernel",
                  "search_range_kernel", "search_words_kernel",
                  "range_items_kernel", "words_items_kernel",
                  "unpack_keys_kernel"))
    grids = {k: item_grid(dev, k) for k in ("range", "words")}
    phase("build", t, f"{_build.library_path().name} built in "
          f"{time.time() - t:.2f}s (ptxas: {ptxas or 'cached library'}; "
          f"{packet_ptxas}); persistent grids: " + ", ".join(
              f"search_{k}_kernel {c} CTAs per SM x {n} SMs"
              for k, (c, n) in grids.items()))

    # 3. Kernel vs plain, on the card: bitwise.
    t = time.time()
    rng = np.random.default_rng(20261016)
    max_abs = 0.0
    n_cases = 0
    timings, brute_work = {}, {}
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
                brute_work[n_live] = (n_rays * n_live,
                                      n_bytes(*args, alive_t, dk, ik))
    times = ", ".join(
        f"n_live={n}: kernel {k:.4f} ms, plain {p:.4f} ms"
        for n, (k, p) in sorted(timings.items())
    )
    phase("kernel", t, f"search_brute == search_brute_reference bitwise on "
          f"{n_cases} cases (n_live {PHASE3_N_LIVE} x R {PHASE3_RAYS}, "
          f"{DEAD:.0%} dead); at R={TIMED_RAYS}: {times}")

    # 3b. The packet kernels vs plain, and vs the brute scan.
    t = time.time()
    packet_times, packet_err, packet_work = check_packet_kernels(dev, rng)
    packet_bound = {label: bound(pairs * MT_OPS, 0, nbytes)
                    for label, (pairs, nbytes) in packet_work.items()}
    phase("kernel", t, "packet kernels at R=" + str(TIMED_RAYS) + ": " + ", ".join(
        f"{label}: kernel {k:.4f} ms, plain {p:.4f} ms, {packet_work[label][0]} "
        f"tested pairs, bound {packet_bound[label][0]:.5f} ms "
        f"({packet_bound[label][1]}), {packet_bound[label][0] / k:.1%} of bound"
        for label, (k, p) in packet_times.items()))

    # 3c. The MXU kernel vs plain, vs the brute scan, and sliced.
    t = time.time()
    mxu_times, mxu_err, mxu_work = check_mxu_kernel(dev, rng)
    mxu_bound = lambda label, prec: bound(
        mxu_work[label][0] * RPP * MXU_EPILOGUE_OPS,
        mxu_work[label][0] * RPP * MXU_MACS * 2 * MXU_PRODUCTS[prec],
        mxu_work[label][1])
    phase("kernel", t, "search_mxu at R=" + str(TIMED_RAYS) + ": " + ", ".join(
        f"{label} {prec}: kernel {k:.4f} ms, plain {p:.4f} ms, "
        f"{mxu_work[label][0] * RPP} tested pairs, bound "
        f"{mxu_bound(label, prec)[0]:.5f} ms ({mxu_bound(label, prec)[1]})"
        for label, by_prec in mxu_times.items()
        for prec, (k, p) in by_prec.items()))

    # 3d. The union-walk kernel vs plain and the default route.
    t = time.time()
    union_times, union_err, union_work = check_union_kernel(dev, rng)
    union_bound = {label: bound(blocks * RPP * MT_OPS, 0, nbytes)
                   for label, (blocks, nbytes) in union_work.items()}
    phase("kernel", t, "search_union at R=" + str(TIMED_RAYS) + ": " + "; ".join(
        f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f", search_union bound {union_bound[label][0]:.5f} ms "
        f"({union_bound[label][1]})"
        for label, ms in union_times.items()))

    # 3e. The shared-memory probe's ladder.
    t = time.time()
    smem_limit, smem_ms, smem_plain_ms, smem_work, ladder = check_smem_probe(dev)
    phase("kernel", t, f"smem_probe: opt-in limit {smem_limit} bytes "
          f"({smem_limit // 4} words); " + ", ".join(
              f"{n}: {'refused (' + str(err.code) + ')' if err else 'OK, == plain'}"
              for n, _, err in ladder) + f"; at the limit kernel {smem_ms:.4f} "
          f"ms, plain {smem_plain_ms:.4f} ms")

    # 4. Main path: the CLI in default mode and under the knobs that pick a
    # kernel, then the two tools, on the card. Every kernel's count is set
    # to 0 just before each run and read just after it.
    kernels = {"search_brute": search_brute, "search_bitmask": search_bitmask,
               "search_packed": search_packed, "search_range": search_range,
               "search_words": search_words, "search_mxu": search_mxu,
               "search_union": search_union, "smem_probe": smem_probe.smem_probe}
    total_launches = dict.fromkeys(kernels, 0)
    traced, means = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra, shape, expect, env, twin, exact in MAIN_RUNS:
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
            with open(out, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
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
            means[label[0]] = mean
            same = ""
            if twin is not None and exact:
                with open(out, "rb") as f, open(
                        os.path.join(tmp, f"main_{twin}.bmp"), "rb") as g:
                    if f.read() != g.read():
                        raise AssertionError(f"{label}: BMP differs from ({twin})'s")
                if rays != traced[twin]:
                    raise AssertionError(f"{label}: {rays} traced rays, ({twin}) "
                                         f"traced {traced[twin]}")
                same = f", BMP byte-identical to ({twin})'s, same ray count"
            elif twin is not None:
                other = read_bmp(os.path.join(tmp, f"main_{twin}.bmp"))
                rel = abs(rays - traced[twin]) / traced[twin]
                dmean = abs(mean - means[twin])
                if rel > TWIN_RAYS_REL or dmean > TWIN_MEAN_ABS:
                    raise AssertionError(
                        f"{label}: {rays} traced rays against ({twin})'s "
                        f"{traced[twin]} (rel {rel:.3g}), mean byte {mean:.3f} "
                        f"against {means[twin]:.3f}")
                same = (f"; against ({twin}): traced rays rel diff {rel:.3g}, "
                        f"mean byte diff {dmean:.4f}, "
                        f"{float((img != other).mean()):.4%} of bytes differ")
            phase("main", t, f"{label}: render {render_s:.3f}s, {rays} rays, "
                  f"{rays / render_s:.4g} rays/s, {launched[expect]} {expect} "
                  f"launches, mean byte {mean:.2f}, BMP sha256 {digest}{same}")

    for label, module, argv, expect in TOOL_RUNS:
        t = time.time()
        for fn in kernels.values():
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = getattr(tools, module).main(argv)
        log = buf.getvalue()
        launched = {k: fn.launches for k, fn in kernels.items()}
        for k, v in launched.items():
            total_launches[k] += v
        if rc != 0:
            raise AssertionError(f"{label}: exit code {rc}\n{log}")
        if launched[expect] < 1:
            raise AssertionError(f"{label}: {expect} never launched")
        print(log, end="", flush=True)
        phase("main", t, f"{label}: {launched[expect]} {expect} launches; "
              f"others: {({k: v for k, v in launched.items() if v and k != expect})}")

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
    # TIMED_RAYS with box_scene at 640 (brute; mxu, split3, as in run (k)),
    # 10,240 (bitmask; union, the union tool's scene) and 163,840 (packed,
    # range and words streamed) triangles, and the probe at the device's
    # limit; the [kernel] lines have the others. Each bound counts the work
    # these inputs need: every (ray, triangle) pair the kernel's culling
    # table makes it test (R x n_live for brute).
    src = "raytracingc_tpu_torch/csrc/{}.cu"
    tpu = "raytracingc_tpu/ops/intersect_pallas.py:{}"
    packet_row = lambda label: (packet_times[label], packet_bound[label])
    brute_pairs, brute_bytes = brute_work[max(TIMED_N_LIVE)]
    rows = [
        ("search_brute", tpu.format(1278), timings[max(TIMED_N_LIVE)],
         bound(brute_pairs * MT_OPS, 0, brute_bytes), max_abs),
        ("search_bitmask", tpu.format(1453),
         *packet_row("K2 box 10,240 (3 words)"), packet_err["search_bitmask"]),
        ("search_packed", tpu.format(869),
         *packet_row("K3 box 163,840 streamed"), packet_err["search_packed"]),
        ("search_range", f"{tpu.format(176)} (K4), {tpu.format(350)} (K5)",
         *packet_row("K5 box 163,840 streamed (RTC_CULL=range)"),
         packet_err["search_range"]),
        ("search_words", f"{tpu.format(428)} (K6), {tpu.format(598)} (K7)",
         *packet_row("K7 box 163,840 streamed (RTC_STREAM_CULL=words)"),
         packet_err["search_words"]),
        ("search_mxu", "raytracingc_tpu/ops/intersect_mxu.py:270",
         mxu_times[MXU_TIMED]["split3"], mxu_bound(MXU_TIMED, "split3"), mxu_err),
        ("search_union", "tools/union_walk_ab.py:43",
         (union_times[UNION_TIMED]["search_union"],
          union_times[UNION_TIMED]["search_union plain"]),
         union_bound[UNION_TIMED], union_err),
        ("smem_probe", "tools/smem_probe.py:20", (smem_ms, smem_plain_ms),
         bound(smem_work[0], 0, smem_work[1]), 0.0),
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
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    } for name, replaces, (k_ms, p_ms), (b_ms, b_by), err in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
