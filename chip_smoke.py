"""Smoke run of raytracingc_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from this checkout's sources (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card (bit for bit; the tensor-core MXU kernel within its contract; the
shading kernel's four entries also through a whole 1080p frame on each of
its two routes; the culling kernel through each word route's entry against
the same entry on a CPU copy of its inputs, its plain version; the
compaction kernel against torch.nonzero and the gathers, and through a
whole frame of each benchmark scene against the same frame with the
compaction's route forced to torch),
drives the renderer's main path through the CLI (the user's entry point) at
every kernel's scene size and under every search knob that picks a kernel,
then its progressive (checkpointed, resumed), bounce-heatmap, trace and
loader-test entry points, runs the two measurement tools through their
entry points, compares a small render on the card with the same render on
the CPU, runs the integrator's other modes and the training path (with
a checkpointed resume), then the multi-rank layer: a world of one rank over
NCCL in this process, and two ranks on the one card over gloo in child
processes of this script (``--parallel-rank``), then the last entry points:
forward-mode derivatives through the production render (``torch.func.jvp``,
``forward_ad``; also sample-sharded, in the child processes;
``torch.func.jacfwd`` and ``torch.func.vmap`` over cameras), the dispatch
calibration grid, the granule counts and the four inverse-rendering
examples. The integrator's modes include the widened ``sample_batch``
path, timed against ``sample_batch=1`` and ``sample_group="auto"``. Each
phase prints one line per step; any failure raises and the script exits
non-zero without printing a result.

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
BRUTE_TIMED = "640 pack-free"  # phase 3's case of the kernel line's K1 row
# Each case runs K1's two entries, the packed rows and the pack-free one
# (the scene's Triangles: a, b = a + AB, c = a + AC, the normals), each
# held bit for bit to the torch scan of its own rows, and the kernel's lanes
# per ray (rtc_search_brute_parts) to ops/search_brute.py::brute_parts.
# Then the cases below, from their own seeded generator so that every later
# phase's data stays that of the runs before: (live triangles, R, lanes):
# "dead" (a share DEAD dead), "none" (alive=None) or "all dead". R = 1 and
# 33 leave most of a CTA's lanes empty, R = 16,384 (a compacted bounce)
# takes 16 lanes a ray; 1,537 and 10,240 triangles pass the staged table
# (TILE_ROWS) and take the tiled walk.
PHASE3_EXTRA = ((640, 65536, "none"), (640, 65536, "all dead"), (257, 1, "dead"),
                (1, 1, "none"), (640, 33, "dead"), (255, 33, "none"),
                (640, 16384, "dead"), (640, 16384, "none"), (1537, 65536, "dead"),
                (10240, 65536, "dead"))
PHASE3_EXTRA_SEED = 20261018
# Timed at R = TIMED_RAYS (events with the host, the host per call, and
# torch.profiler's device time): the packed entry at TIMED_N_LIVE with DEAD
# dead lanes, at 640 triangles also with every lane live (alive=None) and
# through the pack-free entry (the one the search dispatch takes, so the
# kernel line's row; its plain version packs the rows, then scans), and the
# brute leg of search_triangles on
# box_scene (10 triangles, no accel used, an all-true alive and no grad:
# the production render's primary search). Each bound counts the live
# pairs (live rays x n_live), as the packet rows count the pairs their
# tables make them test; the all-pairs bound (R x n_live) is printed beside
# it.

# Phase 3b: the packet kernels against their plain versions, bit for bit,
# and their live-lane winners against a brute scan over all live triangles,
# which reads no culling word: at TIMED_RAYS the torch scan
# (search_brute_reference); at the ragged count, whose last packet is part
# filled, K1 (search_brute, held bit for bit to the torch scan in phase 3),
# itself held bit for bit to the torch scan on the last BRUTE_TAIL rays and
# BRUTE_SAMPLE more drawn from their own seeded generator (the torch scan of
# all 100,003 rays by 163,840 triangles takes seconds a call). (label,
# scene, live triangles, knobs, expected kernel); the
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
BRUTE_TAIL = 64
BRUTE_SAMPLE = 4096
WHOLE_PLANE = ("K5 box 163,840 streamed, whole-plane spans (RTC_CULL=range)",
               "K6 box 40,960 resident, whole-plane rays (RTC_STREAM_CULL=words)",
               "K7 box 163,840 streamed, whole-plane rays (RTC_STREAM_CULL=words)")
SECONDARY_SEED = 20261017
SECONDARY = " [secondary]"  # label suffix of a case's secondary-like timing

# Phase 3c: the MXU kernel (K8) against its plain version in both
# precisions, its live-lane winners against the brute scan, the slicing
# check and two runs bitwise equal, at R in PHASE3_RAYS with DEAD dead
# lanes (coherent packets) and at TIMED_RAYS on secondary-like packets; its
# pack kernel against mxu_fragments bit for bit, its count kernel against
# mxu_items from junk-filled buffers, and the CUDA unpack with the dead
# lanes against unpack_keys. (label, scene,
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

# Phase 3d: the union-walk kernel (K9, the words kernel with one word row
# per program) against its plain version and, on live lanes, the brute
# scan, bit for bit, on coherent and secondary-like rays; timed beside K2
# (and K8 where the scene fits it) on the same rays.
UNION_CASES = (
    ("box 2,560 (--tessellate 4)", "box", 2560),
    ("box 10,240 (--tessellate 5)", "box", 10240),
)
UNION_TIMED = "box 10,240 (--tessellate 5)"  # the union tool's scene

# The kernels whose ptxas report must show no spills (the build fails the
# smoke otherwise): K1 (every instantiation), the item searches, K8's and
# the words kernel K9 runs.
NO_SPILLS = ("search_brute_kernel", "search_range_kernel", "search_words_kernel",
             "search_mxu_kernel", "mxu_pack_kernel", "mxu_items_kernel",
             "shade_kernel", "cull_words_kernel", "compact_kernel")
# The K1 instantiation whose MT loop tools/sass_loop.py counts: 8 lanes a
# ray over a staged table (TIMED_RAYS rays at 640 triangles).
SASS_KERNEL = "search_brute_kernelILi8ELb0E"

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

# Runs (r)-(u), on the main path after (a)-(n): the CLI's last single-device
# flags and what they call. (r): run (b)'s frame rendered progressively
# through --checkpoint F --batch-spp 2 (K1): as many traced rays as (b),
# every BMP byte within 1 of (b)'s (the sample average re-associates), the
# checkpoint's __step__ 8; through the API, render_progressive against
# render within REASSOC_PROGRESSIVE (the JAX package's bound,
# tests/test_utils.py:45) with equal counts, and its checkpoint's sum equal
# to (r)'s bit for bit. (r'): the same API render stopped by an on_batch
# that raises after batch 2, then resumed through the CLI on its checkpoint:
# a BMP byte-identical to (r)'s and a linear image equal to the
# uninterrupted API run's bit for bit. (s): --debug-bounces on (m)'s scene
# (--tessellate 4, K2): one traced ray a pixel, bytes of k/8 only; the API's
# render_debug of the frame holds only multiples of 1/8 and tonemaps to the
# CLI's bytes; at DEBUG_SMALL the card equals the CPU port on >=
# MIN_CLOSE_FRAC of the pixels (phase 5's rule). (t): --trace DIR on
# TRACE_FLAGS (K1): DIR holds one Chrome trace whose device kernel events
# include search_brute, as many as the wrapper counted. (u): objtest on
# examples/box_scene.txt --txt --native and on an OBJ + MTL (OBJTEST_OBJ,
# OBJTEST_MTL) written to a temporary directory: exit 0, the native arrays
# equal to the Python parser's.
PROGRESSIVE = dict(width=1920, height=1080, spp=8, max_bounce=8)
PROGRESSIVE_FLAGS = ["-s", str(PROGRESSIVE["width"]), str(PROGRESSIVE["height"]),
                     "--spp", str(PROGRESSIVE["spp"]), "-b",
                     str(PROGRESSIVE["max_bounce"])]
PROGRESSIVE_BATCH = 2
PROGRESSIVE_STOP = 4  # samples done when the interrupted run stops (batch 2)
REASSOC_PROGRESSIVE = dict(rtol=2e-6, atol=2e-7)
DEBUG = dict(width=1920, height=1080, max_bounce=8)
DEBUG_TESSELLATE = 4
DEBUG_FLAGS = ["-s", str(DEBUG["width"]), str(DEBUG["height"]), "-b",
               str(DEBUG["max_bounce"]), "--tessellate", str(DEBUG_TESSELLATE)]
DEBUG_SMALL = dict(width=64, height=64, max_bounce=8)
TRACE_FLAGS = ["-s", "128", "128", "--spp", "4"]
OBJTEST_OBJ = """\
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 1
vn 0 0 1
vn 0.6 0 0.8
usemtl glow
f 1/1/1 2/1/1 3/1/1
usemtl shiny
f 2/1/2 4/1/2 3/1/2 1/1/1
usemtl missing
f 3/1/1 2/1/2 4/1/2
"""
OBJTEST_MTL = "newmtl glow\nKd 0.9 0.8 0.7\nKe 5 1 1\nnewmtl shiny\nKd 0.1 0.2 0.3\nNs 250\n"

# Phase 5: the port on the card against the port on the CPU. Same tolerance
# as tests/test_torch_render.py: CPU and CUDA libm differ by ulps in log/cos
# (Box-Muller), which can send a ray near an edge down another path.
SMALL = dict(width=32, height=32, spp=4, max_bounce=4)
# Phase 3f: the shading kernel's entries against their plain versions, bit
# for bit, at these lanes (the share DEAD dead, and all alive); the
# Morton-permuted scene at SHADE_PERM_LANES; timed at a loop's width.
SHADE_LANES = (1, 33, 16384, 65536)
SHADE_PERM_LANES = (16384,)
SHADE_TIMED = 20000
SHADE_HOST_CALLS = 2000  # calls a host timing of the route and the tables
SHADE_FRAME = dict(width=1920, height=1080, spp=2, max_bounce=8)
# Bytes a lane of the bounce entry moves: pos, d, thr, light (4 x 12), the
# state (8) and the winner (hit 1, is_tri 1, idx 4) in; pos, d, thr, light,
# state and alive (1) out.
SHADE_LANE_BYTES = 4 * 12 + 8 + 6 + 4 * 12 + 8 + 1
PIXEL_RTOL = PIXEL_ATOL = 1e-4
# Phase 3g: the culling prelude's kernel (csrc/cull_words.cu, through each
# word route's entry: culling.packet_block_masks, packet_tile_words[_multi],
# program_union_words) against the same entry on CPU copies of its inputs
# (the kernel's plain version, culling.cull_words_reference) bit for bit, at R in
# CULL_RAYS: (label, scene, live triangles, knobs); the scene is the SPD
# tetra of the benchmark, a seeded soup or box_scene tessellated to that
# count. Each case's rays: coherent and secondary-like packets with a share
# DEAD of dead lanes, the coherent rays with alive=None, and the coherent
# rays with NaN, infinite, zero, -0.0 and +-1e-21 components in live lanes.
CULL_RAYS = (65536, 100003)
CULL_SEED = 20261018  # its own generator: the later phases' data stays as it was
CULL_CASES = (
    ("K2 spd_tetra (5 words)", "tetra", 16384, {}),
    ("K2 soup 1,600 (1 word)", "soup", 1600, {}),
    ("K2 soup 31,744 (8 words)", "soup", 31744, {}),
    ("K3 box 40,960 resident", "box", 40960, {}),
    ("K3 box 163,840 streamed", "box", 163840, {}),
    ("K6 box 40,960 resident (RTC_STREAM_CULL=words)", "box", 40960,
     {"RTC_STREAM_CULL": "words"}),
    ("K7 box 163,840 streamed (RTC_STREAM_CULL=words)", "box", 163840,
     {"RTC_STREAM_CULL": "words"}),
    ("K8 box 640 (RTC_KERNEL=mxu)", "box", 640, {"RTC_KERNEL": "mxu"}),
)
# Timed on the benchmark's K2 scene at the main path's shapes: a 1080p
# chunk's primary rays (every lane live) and a compacted bounce's
# secondary-like rays.
CULL_TIMED = "K2 spd_tetra (5 words)"
CULL_TIMED_RAYS = (65536, 16384)
TETRA_SCENE = os.path.join(HERE, "portbench", "configs", "spd_tetra.txt")
TETRA_CAMERA = dict(origin=(48.0, -48.0, -340.0), target=(0.0, 0.0, 0.0),
                    fov=0.11 / (0.5 * 0.036 * 1080 / 1920))
# FP32 operations of one (ray, box) slab test (csrc/cull_words.cu
# slab_hit): 6 subtracts, 6 multiplies, 6 min/max of the slabs, 4 of the
# reductions, the max with 0 and the compare; and of a live ray's
# reciprocal: 3 abs compares, 3 selects and 3 divisions.
CULL_SLAB_OPS = 24
CULL_RAY_OPS = 9
# Phase 3h: the compaction kernel (csrc/compact.cu) against torch.nonzero
# and the gathers (its plain version, ops/compact.py compact_reference, run
# on the card) bit for bit, at COMPACT_LANES lanes by COMPACT_DENSITIES live
# shares: a bounce's compaction (lane ids, five rows of 12 and 8 bytes, the
# dead lanes' radiance written back into an image) and the trace entry's
# and the hit front's (no ids; rows of 12, 8 and 4 bytes), into buffers
# holding junk; then COMPACT_BURST launches back to back over
# COMPACT_BURST_LANES (past the status words first allocated, so they
# grow), each launch's count and lanes checked (the epochs and tickets);
# then a whole frame of the benchmark's tetra and Cornell box
# (COMPACT_CONFIGS, each with its scene, sky and camera; COMPACT_FRAME) on
# the kernel route == the same frame with the compaction's route forced to
# torch (compact.route replaced here, the shading kernel on in both);
# timed at COMPACT_TIMED lanes (a bounce's, the share COMPACT_TIMED_LIVE
# live) beside the torch compaction it replaces.
COMPACT_LANES = (1, 255, 256, 65536, 131072, 524288)
COMPACT_DENSITIES = (0.0, 0.01, 0.3, 0.7, 1.0)
COMPACT_BURST = 1000
COMPACT_BURST_LANES = (65536, 1, 1100000, 1025, 16384, 300001, 255)
COMPACT_FRAME = dict(width=1920, height=1080, spp=2, max_bounce=8)
COMPACT_SEED = 20261019  # its own generator: the later phases' data stays as it was
COMPACT_TIMED = 65536
COMPACT_TIMED_LIVE = 0.7
COMPACT_CONFIGS = ("spd_tetra", "cornell")  # the benchmark's, portbench/configs
MIN_CLOSE_FRAC = 0.995
MAX_MEAN_ABS = 1e-3
MAX_COUNT_REL = 1e-3


# Phase 6: the integrator's other modes on run (b)'s scene at 1920x1080, 8
# bounces, spp cut from 8 to 4 (so that sample_group 2 and "auto", which
# takes 4 at 65,536-ray chunks, differ): the differentiable fast forward
# and sample_group 2 and "auto" equal production bit for bit (values and
# traced rays); the plain full-width oracle (compact=False) agrees to float
# re-association (REASSOC, the JAX package's bound in
# tests/test_utils.py::test_early_exit_matches_scan) with equal counts.
MODES_RUN = dict(width=1920, height=1080, spp=4, max_bounce=8)
REASSOC = dict(rtol=3e-6, atol=3e-7)
# The widened sample_batch path (its own association, sum_s(light0 +
# rest_s), as the oracle's): sample_batch 2, 4 and "auto" (4 at 4 spp)
# under production and under early_exit=False (the masked scan), on
# MODES_RUN, and "auto" at 10,240 triangles (--tessellate 5, K2): counts
# equal to production's, images within REASSOC. Then SB_ROUNDS alternating
# rounds (each round's order reversed from the last; the phase's renders
# before them warm the card) at SB_RUN of
# sample_batch 1, "auto" and 8 and sample_group "auto", each render synced
# and timed on the host's clock: the median wall, the search launches per
# frame and rays/s; sample_batch 8 held to 1 (counts, REASSOC), "auto" to 8
# and sample_group "auto" to 1 bit for bit.
SB_K2_TESSELLATE = 5
SB_RUN = dict(width=1920, height=1080, spp=8, max_bounce=8)
SB_ROUNDS = 5
SB_TIMED = {"sample_batch 1": {}, "sample_batch auto": dict(sample_batch="auto"),
            "sample_batch 8": dict(sample_batch=8),
            "sample_group auto": dict(sample_group="auto")}

# Run (q): the training path on box_scene --tessellate 4 (2,560 triangles,
# the bitmask route K2) at the JAX bench's train defaults (bench.py:76-82):
# 256x256, spp 2, 4 bounces. TRAIN_STEPS steps of fit_scene on the
# albedo, then on geometry (the face normals and vertices b, c: the
# substring rule makes "triangles.a" match albedo too) with the accel
# refreshed every step, then of fit_camera. The target is the scene's own
# render (production mode); the albedo run starts from albedo x 0.5, the
# geometry run from the true scene against a 0.9-dimmed target, the camera
# run from the origin moved by (0.12, -0.08, 0.1); then the geometry run
# again with accel_rebuild_every=2. Checkpoints: the albedo run and the
# rebuilding geometry run, TRAIN_RESUME_AT steps with a checkpoint, then
# resumed to TRAIN_STEPS, must equal their uninterrupted runs bit for bit
# (the resumed losses, the fitted leaves and accel).
TRAIN = dict(width=256, height=256, spp=2, max_bounce=4)
TRAIN_TESSELLATE = 4
TRAIN_STEPS = 5
TRAIN_RESUME_AT = 3  # steps of the interrupted run before its resume
TRAIN_GEOMETRY = ["triangles.normal", "triangles.b", "triangles.c"]
# Gradients on the card against the CPU port, one step at 32x32 (the
# scene's leaves, loss mean(radiance * w) with w from a seeded generator):
# per leaf, |g_cuda - g_cpu|_2 <= GRAD_REL |g_cpu|_2; CUDA's and the CPU's
# log/cos/pow differ by ulps (phase 5), which moves gradients by roughly
# that much, and a path that turns at an edge would move a leaf by more.
GRAD_RUN = dict(width=32, height=32, spp=2, max_bounce=4)
GRAD_REL = 1e-3
# The FD check on the card: tests/test_diff.py's settings and bar (>= 0.9)
# on box_scene --tessellate 4 with its albedo ties broken from FD_SEED, but
# with a step of 1e-2: at 1e-3 the loss moves by about one float32 ulp along
# .env.sun_focus, so its FD is quantised (the CPU port read 7.4506e-5, two
# ulps over the step, against a gradient of 6.950e-5; the card read 0 of 8
# probes in its first run), where 1e-2 reads 6.929e-5. At 16x16 (tests/test_diff.py's 8x8 sees too few pixels of this scene: on the
# CPU port its rate read 0.83-0.92 over three untying seeds, the misses on
# leaves whose gradient is near the FD noise, e.g. .env.sun_focus), with 8
# probes a leaf (CPU port: 0.97-0.98 over the same seeds, every miss on
# .triangles.emission, whose FD is float32 noise beside the emitter's bright
# pixels).
FD_RUN = dict(width=16, height=16, spp=2, max_bounce=2, eps=1e-2, rtol=2e-2,
              atol=5e-6, probes_per_leaf=8)
FD_SEED = 20261017
FD_BAR = 0.9

# Phase 7, the multi-rank layer (raytracingc_tpu_torch/parallel).
# Run (v), a world of one rank over NCCL in this process: render_sharded by
# pixels, samples and both equal render bit for bit on run (b)'s scene at
# PARALLEL (K1); render_sharded(scene_sharding="blocks") on box_scene
# --tessellate PARALLEL_TESSELLATE (10,240 triangles: K2 on the shard's
# accel) equals its replicated render bit for bit; one make_train_step
# step on run (q)'s scene at TRAIN on the one-rank mesh equals fit_scene's
# single-device step (make_train_step without a mesh): loss and gradients
# bit for bit. Run (w), PARALLEL_RANKS ranks on this one card over gloo
# (NCCL refuses two ranks on one card), each a child process of this script
# (``chip_smoke.py --parallel-rank``): the CLI with --shard pixels and the
# multi-process flags at PARALLEL writes the single-device CLI's BMP byte
# for byte with the same traced rays; then, in a world of their own, the
# block-sharded render at PARALLEL_TESSELLATE (5,120 triangles a rank) is
# the replicated render's bits, the spp-sharded render (spp dimension 2)
# equals the mean of the two offset single-device renders bit for bit (a
# sum of two is order-free), and a 2x1 make_train_step step (every leaf;
# the accel refreshed) has the single-device step's gradients within
# PARALLEL_GRAD_REL (relative L2 per leaf: the pixel sum's association
# differs) and its loss within the same. A child that fails fails the smoke.
PARALLEL = dict(width=1920, height=1080, spp=2, max_bounce=8)
PARALLEL_TESSELLATE = 5
PARALLEL_RANKS = 2
PARALLEL_GRAD_REL = 1e-5
PARALLEL_LR = 0.05
PARALLEL_TIMEOUT = 400

# Phase 8, the last entry points: forward mode, the two calibration tools
# and the four inverse-rendering examples.
# Run (x), forward mode on box_scene (K1): torch.func.jvp and forward_ad
# through render(early_exit=True) at FWD_RUN, with tangents of ones on the
# triangles' albedo and emission and a seeded normal one on vertex a
# (fwd_tangents): the primal equals the production render bit for bit and
# each launches exactly the production render's K1 launches, no other
# kernel; at FWD_SMALL the jvp of a weighted loss (weights from a seeded
# CPU generator) equals grad . v of the differentiable fast forward within
# FWD_REV_RTOL (each sums 3 x 65,536 pixel terms and the leaves' products
# in its own order; the CPU test reads < 1e-5). In run (w), the two gloo
# ranks' sample-sharded jvp at FWD_SMALL equals the mean of the one-device
# jvps of the two offset renders bit for bit (a sum of two is order-free).
FWD_RUN = dict(width=1920, height=1080, spp=2, max_bounce=8)
FWD_SMALL = dict(width=256, height=256, spp=2, max_bounce=8)
FWD_REV_RTOL = 1e-4
FWD_SEED = 20261017
# Run (x''): torch.func.jacfwd of a JAC_RUN render of box_scene (K1) by the
# camera pose (origin, view direction: fit_camera's parameters) and the
# albedo of triangles JAC_ROWS, through production and early_exit=False:
# every column within JAC_REL (of the column's largest |entry|) of the
# one-direction torch.func.jvp's (the CPU tests read them equal bit for
# bit), K1 launched exactly as often as by one production render (the
# search runs once on the primal, not once per direction). Then
# torch.func.vmap of the production render over JAC_CAMERAS poses: each
# image and count the separate render's, bit for bit.
JAC_RUN = dict(width=32, height=32, spp=2, max_bounce=4)
JAC_ROWS = (0, 3, 8)  # a wall, the floor and the ceiling emitter
JAC_REL = 1e-6
JAC_CAMERAS = ((0.0, 0.0, 0.0, 0.0, 0.0, 0.0), (0.3, -0.1, 0.2, 0.0, 0.05, 0.0),
               (-0.2, 0.1, 0.0, 0.04, 0.0, -0.03))  # offsets of the pose
# Run (y), raytracingc_tpu_torch/tools/dispatch_calibration.py's grid
# through its calibrate(): both legs in this process, each (cell, leg)
# counted on its own (the brute leg launches only K1, the packet leg only
# K2), the legs' BMP bytes and traced rays equal in every cell (checked by
# calibrate). Every cell's spp is cut DISPATCH_SPP_CUT-fold (128x128: 64
# -> 16, 1920x1080: 8 -> 2) and timed once after its warm run (the tool:
# the best of 2) to bound the run time; the tool's own run keeps the JAX
# tool's spp.
DISPATCH_SPP_CUT = 4
# Run (z), raytracingc_tpu_torch/tools/granule_analysis.py: at
# GRANULE_LEVEL (163,840 triangles) the counts of one 65,536-ray chunk of
# the 1080p primary rays (pixels GRANULE_CHUNK onwards, the middle chunk of
# tools/chunk_profile.py) on the card equal the CPU port's, integer for
# integer; then the tool's entry point runs the whole frame at
# GRANULE_FULL_LEVEL (655,360 triangles) on the card and prints its table.
GRANULE_LEVEL = 7
GRANULE_FULL_LEVEL = 8
GRANULE_CHUNK = 1 << 20
# Run (x'), the four examples of raytracingc_tpu_torch/examples/ on the card
# at their JAX tests' steps (tests/test_diff.py: vertices 60, camera 120,
# sphere 150; albedo at its default 80) and bars: (losses[-1] / losses[0],
# error after / before) below these (albedo: its exit code 0, the wall's
# error fallen). Every scene has <= 128 triangles: each launches K1 only.
EXAMPLES = {"inverse_vertices": (60, 0.1, 0.25), "inverse_camera": (120, 0.2, 0.25),
            "inverse_sphere": (150, 0.2, 0.25)}


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {time.time() - t0:.3f}s {msg}", flush=True)


# The kernels of the integrator's kernel route: every render with no
# derivative on the card launches both, and no other run either.
ROUTE_KERNELS = ("shade_kernel", "compact_kernel")


def check_launches(label: str, launched: dict, expect, shade: bool) -> None:
    """Raise unless every kernel of ``expect`` (a name or a tuple) launched,
    the shading and compaction kernels launched (``shade``: a render with
    no derivative on the card) or did not (a gradient, a tangent, a vmap or
    the heatmap's walk: the torch route), and no other kernel did."""
    expect = (expect,) if isinstance(expect, str) else expect
    for k in expect:
        if launched[k] < 1:
            raise AssertionError(f"{label}: {k} never launched: {launched}")
    for k in ROUTE_KERNELS:
        if shade != (launched[k] > 0):
            raise AssertionError(f"{label}: {k} launched {launched[k]} times "
                                 f"(expected {'some' if shade else 'none'})")
    others = {k: v for k, v in launched.items()
              if k not in expect and k not in ROUTE_KERNELS and v}
    if others:
        raise AssertionError(f"{label}: other kernels launched: {others}")


def counted(kernels: dict, totals: dict, expect: str, label: str, fn,
            shade: bool = True):
    """Run ``fn()`` with every kernel's launch count set to 0 just before it
    and read just after; add the counts to ``totals``. Raises unless
    ``expect`` launched, the shading kernel launched or not as ``shade``
    says, and no other kernel did (:func:`check_launches`). Returns
    ``(fn's result, launches of expect)``."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    launched = {k: f.launches for k, f in kernels.items()}
    for k, v in launched.items():
        totals[k] += v
    check_launches(label, launched, expect, shade)
    return out, launched[expect]


def run_cli(cli_main, label: str, argv: list) -> tuple[str, float, int]:
    """The port's CLI on the card with ``--profile``: ``(log, render
    seconds, traced rays)``; raises on a non-zero exit."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--device", "cuda", "--triangles", BOX_SCENE, "--profile",
                       *argv])
    log = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"{label}: cli exit code {rc}\n{log}")
    prof = re.search(r"render=([0-9.]+)s rays=(\d+)", log)
    if prof is None:
        raise AssertionError(f"{label}: no [profile] line\n{log}")
    return log, float(prof.group(1)), int(prof.group(2))


def check_progressive(dev, tmp, cli_main, count, b_bmp, b_rays) -> dict:
    """Runs (r) and (r'). ``count(expect, label, fn)`` runs ``fn`` under the
    launch counters. Returns the numbers of their phase lines."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.render import progressive
    from raytracingc_tpu_torch.render.image import read_bmp
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    out = {}
    # (r) through the CLI, each checkpoint write timed after a device sync:
    # its time is the copy of the sum to the host and the file's write.
    saves = []
    save = progressive.save_pytree

    def timed_save(*args, **kw):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        save(*args, **kw)
        saves.append(time.perf_counter() - t)

    ck_r, bmp_r = os.path.join(tmp, "r.npz"), os.path.join(tmp, "r.bmp")
    progressive.save_pytree = timed_save
    try:
        (_, wall, rays), n = count("search_brute", "r", lambda: run_cli(
            cli_main, "r", [*PROGRESSIVE_FLAGS, "-o", bmp_r, "--checkpoint", ck_r,
                            "--batch-spp", str(PROGRESSIVE_BATCH)]))
    finally:
        progressive.save_pytree = save
    img_r, img_b = read_bmp(bmp_r), read_bmp(b_bmp)
    worst = int(np.abs(img_r.astype(int) - img_b.astype(int)).max())
    if rays != b_rays or worst > 1:
        raise AssertionError(f"r: {rays} traced rays against (b)'s {b_rays}, "
                             f"bytes differ by up to {worst}")
    with np.load(ck_r) as data:
        if int(data["__step__"]) != PROGRESSIVE["spp"] or int(data["leaf_1"]) != rays:
            raise AssertionError(f"r: checkpoint step {data['__step__']}, count "
                                 f"{data['leaf_1']}")
    out["r"] = dict(wall=wall, rays=rays, launches=n, saves=saves,
                    bytes_differ=float((img_r != img_b).mean()))

    # The API: render_progressive against render, and against (r)'s sum.
    scene = scene_from_triangles_txt(BOX_SCENE).to(dev)
    cam = Camera.look_at(device=dev)
    frame = PROGRESSIVE
    sync = lambda: torch.cuda.synchronize(dev)
    ck_api, ck_stop = os.path.join(tmp, "api.npz"), os.path.join(tmp, "stop.npz")
    with torch.no_grad():
        t = time.time()
        (one, n_one), _ = count("search_brute", "r api render", lambda: render(
            scene, cam, **frame))
        sync()
        t_one = time.time() - t
        t = time.time()
        (prog, n_prog), _ = count("search_brute", "r api progressive", lambda: (
            progressive.render_progressive(
                scene, cam, **frame, batch_spp=PROGRESSIVE_BATCH,
                checkpoint_path=ck_api)))
        sync()
        t_prog = time.time() - t
    np.testing.assert_allclose(prog.cpu().numpy(), one.cpu().numpy(),
                               **REASSOC_PROGRESSIVE)
    if not n_prog == n_one == rays:
        raise AssertionError(f"r api: rays {n_prog} progressive, {n_one} one-shot, "
                             f"{rays} CLI")
    with np.load(ck_r) as a, np.load(ck_api) as b:
        if not (np.array_equal(a["leaf_0"].view(np.int32), b["leaf_0"].view(np.int32))
                and int(a["leaf_1"]) == int(b["leaf_1"])):
            raise AssertionError("r: the CLI's checkpoint is not the API run's")
    out["api"] = dict(one=t_one, prog=t_prog,
                      max_rel=float(((prog - one).abs() / one.abs().clamp_min(1e-30))
                                    .max()))

    # (r'): stopped after batch 2, resumed through the CLI.
    class Stop(Exception):
        pass

    def stop_after_batch_2(done, total, partial):
        if done >= PROGRESSIVE_STOP:
            raise Stop

    def interrupted():
        try:
            progressive.render_progressive(
                scene, cam, **frame, batch_spp=PROGRESSIVE_BATCH,
                checkpoint_path=ck_stop, on_batch=stop_after_batch_2)
        except Stop:
            return True
        return False

    with torch.no_grad():
        stopped, _ = count("search_brute", "r' stopped", interrupted)
    with np.load(ck_stop) as data:
        step = int(data["__step__"])
    if not stopped or step != PROGRESSIVE_STOP:
        raise AssertionError(f"r': stopped {stopped}, checkpoint step {step}")
    bmp_r2 = os.path.join(tmp, "r2.bmp")
    (_, wall2, rays2), n2 = count("search_brute", "r'", lambda: run_cli(
        cli_main, "r'", [*PROGRESSIVE_FLAGS, "-o", bmp_r2, "--checkpoint", ck_stop,
                         "--batch-spp", str(PROGRESSIVE_BATCH)]))
    with open(bmp_r, "rb") as f, open(bmp_r2, "rb") as g:
        if f.read() != g.read():
            raise AssertionError("r': the resumed BMP differs from (r)'s")
    with np.load(ck_stop) as data:
        resumed = torch.from_numpy(data["leaf_0"]).to(dev) / float(frame["spp"])
        step = int(data["__step__"])
    if rays2 != rays or step != frame["spp"]:
        raise AssertionError(f"r': {rays2} traced rays against {rays}, step {step}")
    if not torch.equal(resumed.view(torch.int32), prog.view(torch.int32)):
        raise AssertionError("r': the resumed image is not the uninterrupted "
                             "API run's bits")
    out["r'"] = dict(wall=wall2, launches=n2)
    return out


def check_debug(dev, tmp, cli_main, count) -> dict:
    """Run (s): the bounce-count heatmap through the CLI and the API."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.render.image import read_bmp, tonemap_to_bytes
    from raytracingc_tpu_torch.render.integrator import render_debug

    bmp = os.path.join(tmp, "s.bmp")
    (_, wall, rays), n = count("search_bitmask", "s", lambda: run_cli(
        cli_main, "s", [*DEBUG_FLAGS, "--debug-bounces", "-o", bmp]), shade=False)
    img = read_bmp(bmp)
    b = DEBUG["max_bounce"]
    levels = set(tonemap_to_bytes(np.arange(b + 1, dtype=np.float32) / b).tolist())
    if img.shape != (DEBUG["height"], DEBUG["width"], 3) or rays != (
            DEBUG["width"] * DEBUG["height"]) or not set(
            np.unique(img).tolist()) <= levels:
        raise AssertionError(f"s: shape {img.shape}, {rays} rays, bytes "
                             f"{sorted(set(np.unique(img).tolist()) - levels)} "
                             f"outside {sorted(levels)}")
    scene = train_scene(dev, tessellate=DEBUG_TESSELLATE)
    cam = Camera.look_at(device=dev)
    t = time.time()
    heat, _ = count("search_bitmask", "s api", lambda: render_debug(
        scene, cam, **DEBUG), shade=False)
    torch.cuda.synchronize(dev)
    t_api = time.time() - t
    if not (torch.equal(heat * b, torch.round(heat * b))
            and float(heat.min()) >= 0.0 and float(heat.max()) <= 1.0):
        raise AssertionError(f"s: the heatmap holds values other than k/{b}")
    if not np.array_equal(tonemap_to_bytes(heat.cpu().numpy()), img):
        raise AssertionError("s: the API's heatmap does not tonemap to the CLI's bytes")
    small, _ = count("search_bitmask", "s small", lambda: render_debug(
        scene, cam, **DEBUG_SMALL), shade=False)
    small_cpu = render_debug(scene.to("cpu"), cam.to("cpu"), **DEBUG_SMALL)
    same = float((small.cpu() == small_cpu).all(-1).float().mean())
    if same < MIN_CLOSE_FRAC:
        raise AssertionError(f"s: card vs CPU heatmap equal on {same:.4f} of pixels")
    hist = np.bincount(np.rint(heat[..., 0].cpu().numpy().ravel() * b).astype(int),
                       minlength=b + 1)
    return dict(wall=wall, api=t_api, launches=n, same=same,
                mean_bounces=float((hist * np.arange(b + 1)).sum() / hist.sum()))


def check_trace(tmp, cli_main, count) -> dict:
    """Run (t): --trace DIR writes a Chrome trace holding the search kernel."""
    import glob

    trace_dir = os.path.join(tmp, "trace")
    (log, wall, rays), n = count("search_brute", "t", lambda: run_cli(
        cli_main, "t", [*TRACE_FLAGS, "-o", os.path.join(tmp, "t.bmp"),
                        "--trace", trace_dir]))
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    if len(files) != 1 or files[0] not in log:
        raise AssertionError(f"t: trace files {files}\n{log}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    brute = [e for e in kernels if "search_brute" in e.get("name", "")]
    if len(brute) != n:
        raise AssertionError(f"t: {len(brute)} search_brute kernel events in the "
                             f"trace, {n} launches counted; kernel names: "
                             f"{sorted({e.get('name', '')[:40] for e in kernels})[:20]}")
    return dict(wall=wall, rays=rays, launches=n, kernels=len(kernels),
                brute_us=sum(float(e.get("dur", 0)) for e in brute),
                device_us=sum(float(e.get("dur", 0)) for e in kernels),
                size=os.path.getsize(files[0]))


def check_objtest(tmp) -> dict:
    """Run (u): the loader entry point on the native C++ loader."""
    import numpy as np

    from raytracingc_tpu_torch import objtest
    from raytracingc_tpu_torch.scene import native
    from raytracingc_tpu_torch.scene.obj_loader import load_obj
    from raytracingc_tpu_torch.scene.triangles_txt import load_triangles_txt

    obj = os.path.join(tmp, "scene.obj")
    with open(obj, "w") as f:
        f.write(OBJTEST_OBJ)
    with open(os.path.join(tmp, "scene.mtl"), "w") as f:
        f.write(OBJTEST_MTL)
    t = time.time()
    logs = []
    for argv in ([BOX_SCENE, "--txt", "--native"], [obj, "--native"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = objtest.main(argv)
        logs.append(buf.getvalue().strip().replace("\n", "; "))
        if rc != 0 or "native C++ loader" not in buf.getvalue():
            raise AssertionError(f"u: objtest {argv}: exit {rc}\n{buf.getvalue()}")
    mesh = load_obj(obj)
    pairs = [(native.load_triangles_txt_native(BOX_SCENE), load_triangles_txt(BOX_SCENE)),
             (native.load_obj_native(obj),
              [getattr(mesh, f) for f in ("verts", "normals", "albedo", "emission",
                                          "smoothness")])]
    for got, want in pairs:
        if not all(np.array_equal(g, w) and g.dtype == w.dtype
                   for g, w in zip(got, want)):
            raise AssertionError("u: the native arrays differ from the Python parser's")
    return dict(seconds=time.time() - t, logs=logs, library=native.library_path().name)


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


def soup_triangles(tri):
    """A random_soup's packed rows as the Triangles of K1's pack-free entry
    (a, b = a + AB, c = a + AC, the normals; no materials read)."""
    import torch

    from raytracingc_tpu_torch.scene.types import Triangles

    a = tri[:, 0:3].contiguous()
    zeros = torch.zeros_like(a)
    return Triangles(a=a, b=a + tri[:, 3:6], c=a + tri[:, 6:9],
                     normal=tri[:, 9:12].contiguous(), albedo=zeros,
                     emission=zeros[:, 0], smoothness=zeros[:, 0])


def check_brute_kernel(dev, rng) -> dict:
    """Phase 3: K1 against its plain version bit for bit, through both
    entries, at PHASE3_N_LIVE x PHASE3_RAYS (soups from ``rng``) and at
    PHASE3_EXTRA (from their own generator); timed at TIMED_RAYS. Returns
    ``{"cases", "parts", "max_abs", "timed": {label: split_times + plain
    ms, bounds}}``; raises on any disagreement."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.ops import _build, search
    from raytracingc_tpu_torch.ops.search_brute import (
        brute_parts,
        pack_triangles,
        search_brute,
        search_brute_reference,
    )
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
    from raytracingc_tpu_torch.tools import cuda_ms, split_times

    lib = _build.load_library()
    extra_rng = np.random.default_rng(PHASE3_EXTRA_SEED)
    cases = [(n, r, "dead", rng) for n in PHASE3_N_LIVE for r in PHASE3_RAYS]
    cases += [(n, r, lanes, extra_rng) for n, r, lanes in PHASE3_EXTRA]
    out = {"cases": 0, "parts": {}, "max_abs": 0.0, "timed": {}}
    timed = out["timed"]

    def split(label, call, args, n_live, alive, result, plain=None):
        v = split_times(call, "search_brute")
        if plain is not None:
            v["plain"] = cuda_ms(plain, 10)
        r = args[0].shape[0]
        live = r if alive is None else int(alive.sum())
        nbytes = n_bytes(*args, *([] if alive is None else [alive]), *result)
        v["pairs"] = live * n_live
        v["bound"] = bound(live * n_live * MT_OPS, 0, nbytes)
        v["all_bound"] = bound(r * n_live * MT_OPS, 0, nbytes)
        timed[label] = v

    for n_live, n_rays, lanes, gen in cases:
        tri, o, d, alive = random_soup(gen, n_live, n_rays)
        if lanes == "all dead":
            alive[:] = False
        o, d, tri = (torch.from_numpy(x).to(dev) for x in (o, d, tri))
        alive_t = None if lanes == "none" else torch.from_numpy(alive).to(dev)
        tris = soup_triangles(tri)
        free_tri = pack_triangles(tris, n_live)
        where = f"n_live={n_live} R={n_rays} ({lanes})"
        parts = int(lib.rtc_search_brute_parts(n_rays, n_live))
        if parts != brute_parts(n_rays, n_live):
            raise AssertionError(f"{where}: the kernel takes {parts} lanes a ray, "
                                 f"brute_parts {brute_parts(n_rays, n_live)}")
        out["parts"][f"{n_live}x{n_rays}"] = parts
        for entry, rows, arg in (("packed", tri, tri), ("pack-free", free_tri, tris)):
            dk, ik = search_brute(o, d, arg, n_live, alive_t)
            dr, ir = search_brute_reference(o, d, rows, n_live, alive_t)
            torch.cuda.synchronize()
            if not torch.equal(ik, ir):
                raise AssertionError(f"{where} {entry}: idx differs on "
                                     f"{int((ik != ir).sum())} rays")
            if not torch.equal(dk.view(torch.int32), dr.view(torch.int32)):
                raise AssertionError(f"{where} {entry}: dst bits differ")
            hits = int((ik >= 0).sum())
            if lanes == "all dead" and hits:
                raise AssertionError(f"{where} {entry}: {hits} dead lanes hit")
            if lanes != "all dead" and n_live > 1 and n_rays > 1 and hits == 0:
                raise AssertionError(f"{where} {entry}: no ray hit")
            out["max_abs"] = max(out["max_abs"], float((dk - dr).abs().max()))
            out["cases"] += 1
        if n_rays != TIMED_RAYS:
            continue
        if gen is rng and n_live in TIMED_N_LIVE:
            args = (o, d, tri)
            split(f"{n_live}", lambda: search_brute(*args, n_live, alive_t), args,
                  n_live, alive_t, (dk, ik),
                  lambda: search_brute_reference(*args, n_live, alive_t))
            if n_live == max(TIMED_N_LIVE):
                free = (o, d, tris.a, tris.b, tris.c, tris.normal)
                split(f"{n_live} pack-free", lambda: search_brute(o, d, tris, n_live, alive_t),
                      free, n_live, alive_t, (dk, ik),
                      lambda: search_brute_reference(o, d, pack_triangles(tris, n_live),
                                                     n_live, alive_t))
        if gen is extra_rng and lanes == "none" and n_live == max(TIMED_N_LIVE):
            args = (o, d, tri)
            split(f"{n_live} all live", lambda: search_brute(*args, n_live), args,
                  n_live, None, (dk, ik))
    box = scene_from_triangles_txt(BOX_SCENE).to(dev)
    _, o, d, _ = random_soup(extra_rng, 1, TIMED_RAYS)
    o, d = (torch.from_numpy(x).to(dev) for x in (o, d))
    act = torch.ones(TIMED_RAYS, dtype=torch.bool, device=dev)
    with torch.no_grad():
        leg = lambda: search.search_triangles(o, d, box.triangles, box.n_triangles,
                                              alive=act, accel=box.accel)
        ld, li = leg()
        want = search_brute_reference(o, d, pack_triangles(box.triangles, box.n_triangles),
                                      box.n_triangles, act)
        if not (torch.equal(li, want[1]) and torch.equal(ld.view(torch.int32),
                                                         want[0].view(torch.int32))):
            raise AssertionError("the brute leg on box_scene differs from the torch scan")
        split("box_scene leg", leg, (o, d, box.triangles.a, box.triangles.b,
                                     box.triangles.c, box.triangles.normal),
              box.n_triangles, act, (ld, li))
    return out


def packet_scene(rng, kind: str, n_live: int):
    """``(Triangles, n_live, ray origin box)``: a soup of triangles (every
    7th duplicating an earlier one, so that equal distances occur) in a
    12-unit cube, or box_scene tessellated to ``n_live`` triangles."""
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt, tessellate
    from raytracingc_tpu_torch.tools.packets import SOUP_ORIGINS, soup_scene

    if kind == "box":
        scene = scene_from_triangles_txt(BOX_SCENE)
        levels = {10 * 4**k: k for k in range(9)}[n_live]
        tris, n = tessellate(scene.triangles, scene.n_triangles, levels=levels)
        return tris, n, ((-5.0, -5.0, -5.0), (5.0, 1.5, 5.0))
    return (*soup_scene(rng, n_live), SOUP_ORIGINS)


def check_packet_kernels(dev, rng, cases=PACKET_CASES, rays=PHASE3_RAYS):
    """Phase 3b. Returns ``({label: (kernel ms, plain ms)}, {kernel name:
    max |dst - plain dst|}, {label: (tested pairs, bytes)})``, the last two
    at R = TIMED_RAYS; raises on any disagreement."""
    import torch

    from raytracingc_tpu_torch.ops import culling, search
    from raytracingc_tpu_torch.ops.accel import BLOCK, build_accel
    from raytracingc_tpu_torch.ops.search_bitmask import (
        bitmask_table,
        card_blocks,
        n_packets,
        search_bitmask,
        search_bitmask_reference,
    )
    from raytracingc_tpu_torch.ops.search_brute import (
        pack_triangles,
        search_brute,
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
    from raytracingc_tpu_torch.utils.profiling import COUNTS

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
        accel_cpu = accel.to("cpu")
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
            where = f"{label}{suffix} R={n_rays}"
            bpt = way.tile // BLOCK
            tiles = (way.n_tiles, bpt, way.granule)
            if way.kernel == "bitmask":
                words = card_words(where, culling.packet_block_masks, o, d, alive,
                                   accel, accel_cpu)
                args = (o, d, words, plane, oi)
                table = bitmask_table(words, accel.n_blocks)
            elif way.kernel == "packed":
                words = card_words(where, culling.packet_tile_words_multi, o, d,
                                   alive, accel, accel_cpu, *tiles)
                args = (o, d, words, plane, oi, way.tile, way.granule)
                table = packed_table(words, bpt, way.granule)
            elif way.kernel == "words":
                words = card_words(where, culling.packet_tile_words, o, d, alive,
                                   accel, accel_cpu, *tiles)
                args = (o, d, words, plane, oi, way.tile, way.granule)
                table = packed_table(words[..., None], bpt, way.granule)
            else:
                first, last = culling.packet_block_ranges(o, d, alive, accel)
                args = (o, d, first, last, plane, oi)
                table = range_table(first, last, plane.shape[1] // BLOCK)
            walked0 = (card_blocks(), COUNTS["search.bitmask_blocks"])
            dk, ik = kern(*args)
            dr, ir = plain(*args)
            torch.cuda.synchronize()
            # search.bitmask_blocks: K2 adds its walked pairs on the card and
            # its plain version on the host, both the words' set bits; K3,
            # which shares the walk, passes no counter.
            walked = (card_blocks() - walked0[0],
                      COUNTS["search.bitmask_blocks"] - walked0[1])
            want = (int(table.sum()),) * 2 if way.kernel == "bitmask" else (0, 0)
            if walked != want:
                raise AssertionError(f"{where}: search.bitmask_blocks moved by "
                                     f"{walked} (card, host), expected {want}")
            if not torch.equal(ik, ir):
                raise AssertionError(f"{where}: idx differs from the plain "
                                     f"version on {int((ik != ir).sum())} rays")
            if not torch.equal(dk.view(torch.int32), dr.view(torch.int32)):
                raise AssertionError(f"{where}: dst bits differ from the plain version")
            if n_rays == TIMED_RAYS:
                db, ib = search_brute_reference(o, d, brute_tri, n, alive)
            else:
                db, ib = search_brute(o, d, brute_tri, n, alive)
                pick = np.random.default_rng([SECONDARY_SEED, case, n_rays]).choice(
                    n_rays - BRUTE_TAIL, BRUTE_SAMPLE, replace=False)
                sel = torch.from_numpy(np.concatenate([
                    pick, np.arange(n_rays - BRUTE_TAIL, n_rays)])).to(dev)
                ds, is_ = search_brute_reference(o[sel], d[sel], brute_tri, n,
                                                 alive[sel])
                if not (torch.equal(ib[sel], is_) and torch.equal(
                        db[sel].view(torch.int32), ds.view(torch.int32))):
                    raise AssertionError(f"{where}: K1 differs from the torch scan "
                                         f"on {int((ib[sel] != is_).sum())} rays")
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
                             f"{int(table.sum())} (packet, block) pairs, "
                             f"search.bitmask_blocks +{walked[0]} on the card")
            if n_rays == TIMED_RAYS and label in TIMED_PACKET:
                timings[label + suffix] = (cuda_ms(lambda: kern(*args), 20),
                                           cuda_ms(lambda: plain(*args),
                                                   TIMED_PACKET[label]))
                work[label + suffix] = (
                    int(table.sum()) * culling.RAY_SUBLANES * BLOCK,
                    n_bytes(*args[:-2 if way.kernel in ("packed", "words")
                                  else None], dk, ik))
        phase("kernel", t, f"{label}: words == their entry on a CPU copy bitwise; "
              f"{name} == plain bitwise, live lanes == "
              f"brute scan (K1 at the ragged R, itself == the torch scan on "
              f"{BRUTE_TAIL + BRUTE_SAMPLE} of its rays); {way.kernel} ({way.tpu}) tile={way.tile} "
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
                words.shape[1], tile // BLOCK, granule, 1)), *bufs)
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
    check_unpack(plain, None, where)
    return int(items.sum())


def check_unpack(plain, alive, where) -> None:
    """The CUDA unpack on the keys of the plain result ``(dst, idx)`` (dead
    lanes, where ``alive`` is False, already (MISS_DST, -1)) equals
    unpack_keys with the dead-lane rule, and the plain result; raises
    otherwise."""
    import torch

    from raytracingc_tpu_torch.ops import search_range
    from raytracingc_tpu_torch.scene.types import MISS_DST

    dr, ir = plain
    packed = torch.where(ir >= 0, search_range.pack_keys(dr, ir.clamp(min=0)),
                         search_range.MISS_KEY)
    if alive is not None:  # dead lanes' keys hold junk hits: the rule drops them
        packed = torch.where(alive, packed, search_range.pack_keys(
            torch.full_like(dr, 1.5), torch.zeros_like(ir)))
    got = search_range.unpack_keys_cuda(packed, alive)
    want_d, want_i = search_range.unpack_keys(packed)
    if alive is not None:
        want_d = torch.where(alive, want_d, MISS_DST)
        want_i = torch.where(alive, want_i, -1)
    for want in ((want_d, want_i), plain):
        if not (torch.equal(got[1], want[1]) and torch.equal(
                got[0].view(torch.int32), want[0].view(torch.int32))):
            raise AssertionError(f"{where}: the CUDA unpack differs from "
                                 f"unpack_keys or from the plain result")


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


def check_mxu_items(words, flags, coeffs, alive, plain, n_blocks, where) -> int:
    """K8's count kernel on these inputs, from junk-filled buffers: its scan
    of the item counts equals that of mxu_items at the source's slice and
    split, its keys the packed miss MISS_KEY and its claim counter 0; and
    the CUDA unpack with ``alive`` equals unpack_keys with the dead-lane
    rule, and the plain result, on that result's keys. Returns the item
    count; raises on any difference."""
    import ctypes

    import torch

    from raytracingc_tpu_torch.ops import _build, search_range
    from raytracingc_tpu_torch.ops.intersect_mxu import mxu_items

    lib = _build.load_library()
    r = alive.shape[0]
    dev = alive.device
    ends = torch.full((words.shape[0],), -5, dtype=torch.int64, device=dev)
    counter = torch.full((1,), 12345, dtype=torch.int64, device=dev)
    keys = torch.full((r,), -7, dtype=torch.int64, device=dev)
    _build.check(lib.rtc_mxu_items(
        words.data_ptr(), flags.data_ptr(), *(ctypes.c_int(x) for x in (
            r, words.shape[1], n_blocks)), ends.data_ptr(), counter.data_ptr(),
        keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "mxu items launch")
    want = torch.cumsum(mxu_items(words, flags, r, n_blocks), 0)
    torch.cuda.synchronize()
    if not torch.equal(ends, want):
        raise AssertionError(f"{where}: the mxu count kernel's scan differs "
                             f"from mxu_items' on {int((ends != want).sum())} programs")
    if not ((keys == search_range.MISS_KEY).all() and int(counter) == 0):
        raise AssertionError(f"{where}: the mxu count kernel left keys other "
                             f"than MISS_KEY or a counter other than 0")
    check_unpack(plain, alive, where)
    return int(ends[-1])


def check_mxu_kernel(dev, rng, cases=MXU_CASES, rays=PHASE3_RAYS):
    """Phase 3c. Returns ``({label: {precision: (kernel ms, plain ms)}},
    max |dst - plain dst| over agreeing live hits, {label: (tested
    (program, block) pairs, bytes)})``, at R = TIMED_RAYS (labels with
    SECONDARY: the secondary-like rays); raises on a broken contract, on a
    control that passes, on a pack kernel that differs from mxu_fragments,
    on a count kernel that differs from mxu_items, on an unpack that
    differs from unpack_keys, or on two runs that differ."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.ops import culling, search
    from raytracingc_tpu_torch.ops.accel import build_accel
    from raytracingc_tpu_torch.ops.intersect_mxu import (
        PRECISIONS,
        mxu_fragments,
        mxu_pack_cuda,
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
    from raytracingc_tpu_torch.tools.packets import packet_rays, secondary_rays

    timings, work, max_err, control = {}, {}, 0.0, None
    for case, (label, kind, n_live) in enumerate(cases):
        t = time.time()
        tris, n, (lo, hi) = packet_scene(rng, kind, n_live)
        tris = tris.to(dev)
        accel = build_accel(tris, n)
        with knobs_set({"RTC_KERNEL": "mxu"}):
            way = search.route(n, accel.n_blocks, search.Knobs.read())
        if way.kernel != "mxu" or accel.mxu_coeffs is None:
            raise AssertionError(f"{label}: routed to {way}, expected mxu")
        coeffs, oi = accel.mxu_coeffs, accel.orig_idx
        for prec in PRECISIONS:
            got = mxu_pack_cuda(coeffs, prec)
            want = mxu_fragments(coeffs, PRECISIONS.index(prec) + 2)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{label} {prec}: the pack kernel differs "
                                     f"from mxu_fragments in "
                                     f"{int((got != want).sum())} halves")
        brute_tri = pack_triangles(tris, n)
        sec_rng = np.random.default_rng([SECONDARY_SEED, 100 + case])
        ray_sets = [(n_rays, "", lambda r: packet_rays(rng, r, lo, hi))
                    for n_rays in rays]
        ray_sets.append((TIMED_RAYS, SECONDARY, lambda r: secondary_rays(
            sec_rng, r, lo, hi)))
        notes = [f"pack kernel == mxu_fragments bitwise in both precisions"]
        for n_rays, suffix, make in ray_sets:
            o, d, alive = (torch.from_numpy(x).to(dev) for x in make(n_rays))
            words, flags = culling.program_union_words(o, d, alive, accel)
            blocks = int(bitmask_table(words, accel.n_blocks).sum())
            pk_blocks = int(bitmask_table(
                culling.packet_block_masks(o, d, alive, accel),
                accel.n_blocks).sum())
            db, ib = search_brute_reference(o, d, brute_tri, n, alive)
            live = int(alive.sum())
            where = f"{label}{suffix} R={n_rays}"
            outs = {}
            for prec in PRECISIONS:
                args = (o, d, words, flags, coeffs, oi, prec, alive)
                dk, ik = search_mxu(*args)
                dk2, ik2 = search_mxu(*args)
                dr, ir = search_mxu_reference(*args, chunk=MXU_PLAIN_CHUNK)
                torch.cuda.synchronize()
                if not (torch.equal(ik, ik2)
                        and torch.equal(dk.view(torch.int32), dk2.view(torch.int32))):
                    raise AssertionError(f"{where} {prec}: two runs differ")
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
                    w2, f2 = culling.program_union_words(o[sl], d[sl], alive[sl],
                                                         accel)
                    parts.append(search_mxu(o[sl], d[sl], w2, f2, coeffs, oi,
                                            prec, alive[sl]))
                if not (torch.equal(torch.cat([p[1] for p in parts]), ik)
                        and torch.equal(torch.cat([p[0] for p in parts]).view(
                            torch.int32), dk.view(torch.int32))):
                    raise AssertionError(f"{where} {prec}: two halves differ from "
                                         f"one call")
                notes.append(f"R={n_rays}{suffix} {prec}: {hits} live hits; vs "
                             f"plain: {contract_note(c)}; vs brute: {b_flips} flips "
                             f"({b_bad} off a boundary)")
                if n_rays == TIMED_RAYS and (prec == "split3" or label == MXU_TIMED):
                    timings.setdefault(label + suffix, {})[prec] = (
                        cuda_ms(lambda: search_mxu(*args), 20),
                        cuda_ms(lambda: search_mxu_reference(
                            *args, chunk=MXU_PLAIN_CHUNK), 2))
                    work[label + suffix] = (blocks, n_bytes(o, d, alive, words, flags,
                                                            coeffs, oi, dk, ik))
            n_items = check_mxu_items(words, flags, coeffs, alive, outs["split3"][1],
                                      accel.n_blocks, where)
            if n_rays == TIMED_RAYS and label == MXU_CONTROL and not suffix:
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
            notes.append(f"R={n_rays}{suffix}: {blocks} (program, block) pairs, "
                         f"{blocks * 1024 * 128} ray-triangle pairs against "
                         f"{pk_blocks * 8 * 128} per packet "
                         f"({blocks * 128 / max(pk_blocks, 1):.3f}x), {n_items} "
                         f"work items (count kernel == mxu_items, unpack == "
                         f"unpack_keys with the dead-lane rule)")
        phase("kernel", t, f"{label}: search_mxu vs plain and brute inside the "
              f"contract, halves == one call, two runs bitwise equal; "
              + "; ".join(notes))
    if control is None:
        raise AssertionError(f"phase 3c ran no control ({MXU_CONTROL!r})")
    return timings, max_err, work


def check_union_kernel(dev, rng, cases=UNION_CASES, rays=PHASE3_RAYS):
    """Phase 3d. Returns ``({label: {kernel: ms}}, max |dst - plain dst|,
    {label: (tested (program, block) pairs, bytes)})``, at R = TIMED_RAYS
    (labels with SECONDARY: the secondary-like rays); raises on any
    disagreement."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.ops import culling
    from raytracingc_tpu_torch.ops.accel import build_accel
    from raytracingc_tpu_torch.ops.intersect_mxu import search_mxu
    from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table, search_bitmask
    from raytracingc_tpu_torch.ops.search_brute import (
        pack_triangles,
        search_brute_reference,
    )
    from raytracingc_tpu_torch.ops.search_union import (
        search_union,
        search_union_reference,
    )
    from raytracingc_tpu_torch.tools import cuda_ms
    from raytracingc_tpu_torch.tools.packets import packet_rays, secondary_rays

    timings, work, max_err = {}, {}, 0.0
    for case, (label, kind, n_live) in enumerate(cases):
        t = time.time()
        tris, n, (lo, hi) = packet_scene(rng, kind, n_live)
        tris = tris.to(dev)
        accel = build_accel(tris, n)
        plane, oi = accel.packed_plane, accel.orig_idx
        brute_tri = pack_triangles(tris, n)
        sec_rng = np.random.default_rng([SECONDARY_SEED, 200 + case])
        ray_sets = [(n_rays, "", lambda r: packet_rays(rng, r, lo, hi))
                    for n_rays in rays]
        ray_sets.append((TIMED_RAYS, SECONDARY, lambda r: secondary_rays(
            sec_rng, r, lo, hi)))
        notes = []
        for n_rays, suffix, make in ray_sets:
            o, d, alive = (torch.from_numpy(x).to(dev) for x in make(n_rays))
            pk_words = culling.packet_block_masks(o, d, alive, accel)
            words, flags = culling.program_union(pk_words)
            args = (o, d, words, flags, plane, oi)
            dk, ik = search_union(*args)
            dr, ir = search_union_reference(*args)
            db, ib = search_brute_reference(o, d, brute_tri, n, alive)
            torch.cuda.synchronize()
            where = f"{label}{suffix} R={n_rays}"
            if not (torch.equal(ik, ir)
                    and torch.equal(dk.view(torch.int32), dr.view(torch.int32))):
                raise AssertionError(f"{where}: search_union differs from its "
                                     f"plain version on {int((ik != ir).sum())} rays")
            if not (torch.equal(ik[alive], ib[alive]) and torch.equal(
                    dk[alive].view(torch.int32), db[alive].view(torch.int32))):
                raise AssertionError(f"{where}: live lanes differ from the brute "
                                     f"scan on {int((ik != ib)[alive].sum())} rays")
            max_err = max(max_err, float((dk - dr).abs().max()))
            blocks = int(bitmask_table(words, accel.n_blocks).sum())
            pk_blocks = int(bitmask_table(pk_words, accel.n_blocks).sum())
            notes.append(f"R={n_rays}{suffix}: {int((ik[alive] >= 0).sum())} live "
                         f"hits, {blocks} (program, block) pairs = "
                         f"{blocks * 1024 * 128} ray-triangle pairs against "
                         f"{pk_blocks * 8 * 128} per packet "
                         f"({blocks * 128 / max(pk_blocks, 1):.3f}x)")
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
                timings[label + suffix] = ms
                work[label + suffix] = (blocks, n_bytes(o, d, words, flags, plane,
                                                        oi, dk, ik))
                pairs = lambda k: (pk_blocks * 8 if k == "search_bitmask"
                                   else blocks * 1024) * 128
                notes.append(f"at R={n_rays}{suffix}: " + ", ".join(
                    f"{k} {v:.4f} ms ({v * 1e6 / pairs(k):.4f} ns per tested pair)"
                    for k, v in ms.items()))
        phase("kernel", t, f"{label}: search_union == plain bitwise, live lanes == "
              f"brute scan, coherent and secondary-like; " + "; ".join(notes))
    return timings, max_err, work


def l2_read_rate(dev) -> float:
    """Bytes per second that one torch.sum reads from a 24 MiB tensor held in
    the 50 MB L2 (after a warm-up): the L2 rate of K10's staging floor."""
    import torch

    from raytracingc_tpu_torch.tools import cuda_ms

    a = torch.ones(6 << 20, dtype=torch.float32, device=dev)
    return a.numel() * 4 / (cuda_ms(lambda: a.sum(), 50) * 1e-3)


def check_smem_probe(dev):
    """Phase 3e: every ladder size up to the device's opt-in limit runs and
    equals the plain version bit for bit; the first size past it is refused
    by the launch with cudaErrorInvalidValue; odd sizes (every body/tail
    split of the staging) equal the plain version. Returns ``(limit bytes,
    {timing: ms} at the limit, (operations, bytes) the function needs, the
    bytes the CTAs stage, the ladder's [(n, equal, refusal)])``. Timings:
    ``tools.split_times``; ``set every call`` the events' time with the limit
    raised again before each launch (the parent's host work); ``device``
    100 launches from one C call between two events, per launch; ``plain``
    the plain version."""
    import torch

    from raytracingc_tpu_torch.tools import cuda_ms, split_times
    from raytracingc_tpu_torch.tools import smem_probe as sp

    limit = sp.optin_bytes(dev)
    sizes = sp.ladder(limit)
    fits = [n for n in sizes if n * 4 <= limit]
    want = fits + [next(n for n in sizes if n * 4 > limit)]
    ladder = sp.run_ladder(dev, sizes)
    if [n for n, _, _ in ladder] != want:
        raise AssertionError(f"smem_probe ran {[n for n, _, _ in ladder]}, "
                             f"expected {want}")
    for n, equal, err in ladder:
        if n * 4 <= limit and (err is not None or not equal):
            raise AssertionError(f"smem_probe n={n}: {err or 'differs from plain'}")
        if n * 4 > limit and (err is None or err.code != sp.CUDA_ERROR_INVALID_VALUE):
            raise AssertionError(f"smem_probe n={n} past the limit: {err!r}")
    x = torch.ones(sp.X_SHAPE, dtype=torch.float32, device=dev)
    for n in (8, 9, 10, 11, 1001, limit // 4 - 1, limit // 4 - 2, limit // 4 - 3):
        sm = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, device=dev)
        if not torch.equal(sp.smem_probe(sm, x), sp.smem_probe_reference(sm, x)):
            raise AssertionError(f"smem_probe n={n}: differs from plain")
    n = limit // 4
    sm = torch.arange(n, dtype=torch.int32, device=dev)
    out = sp.smem_probe(sm, x)
    # Per tile of x: three table words read, two int adds and a conversion;
    # per element of x: one add.
    tiles = x.shape[0] // sp.TILE_ROWS
    work = (x.numel() + 3 * tiles, n_bytes(x, out) + 3 * 4 * tiles)
    ms = split_times(lambda: sp.smem_probe(sm, x), "smem_probe")
    ms["set every call"] = cuda_ms(lambda: sp.smem_probe(sm, x, set_limit=True), 50)
    ms["device"] = cuda_ms(lambda: sp.smem_probe(sm, x, launches=100), 5) / 100
    ms["plain"] = cuda_ms(lambda: sp.smem_probe_reference(sm, x), 50)
    return limit, ms, work, 4 * sp.staging_split(n)[0] * tiles, ladder


def shade_inputs(np_rng, n: int, dev):
    """Lanes for the shading kernel: rays from inside box_scene's room (hits
    on the walls, the emitter and the sphere; misses through its open front
    and top, to the sky, the sun and the ground) and from outside it,
    positive throughputs and lights, RNG states in [0, 2**32), and a mask
    with the share DEAD of tools/packets.py dead."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.tools.packets import DEAD

    inside = np_rng.uniform([-5, -5, -5], [5, 1.5, 5], (n // 2, 3))
    outside = np_rng.uniform([-30, -30, -30], [30, 30, -10], (n - n // 2, 3))
    d = np_rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    return dict(
        pos=f32(np.concatenate([inside, outside])), d=f32(d),
        thr=f32(np_rng.uniform(0.05, 2.0, (n, 3))),
        light=f32(np_rng.uniform(0.0, 3.0, (n, 3))),
        state=torch.from_numpy(np_rng.integers(0, 2**32, n, dtype=np.int64)).to(dev),
        alive=torch.from_numpy(np_rng.random(n) >= DEAD).to(dev))


def check_shade_kernel(dev, np_rng, run=SHADE_FRAME):
    """Phase 3f: the shading kernel's four entries against their plain
    versions on the card, bit for bit (ops/shade.py; SHADE_LANES lanes,
    the share DEAD dead and all alive, box_scene with and without its sphere, and its
    64-fold tessellation through the Morton-permuted resolve table), then a
    1080p frame of box_scene (2 spp, 8 bounces) through the kernel route
    against the same frame through the torch route (early_exit=False with
    the albedo requiring grad): values and ray count equal, each frame on
    its route alone. Returns ``{"cases", "frame", "timed", "report"}``:
    ``timed`` the bounce entry at SHADE_TIMED lanes (tools.split_times:
    events, host a call, the profiler's device time; the plain version's
    events; the bytes bound)."""
    import dataclasses
    import timeit

    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.ops import _build, shade
    from raytracingc_tpu_torch.ops.intersect import nearest_hit, resolve_hit, with_perm_resolve
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene import builder as tb
    from raytracingc_tpu_torch.scene.types import with_leaves
    from raytracingc_tpu_torch.tools import cuda_ms, knobs_set, split_times
    from raytracingc_tpu_torch.utils.profiling import COUNTS

    box = tb.scene_from_triangles_txt(BOX_SCENE).to(dev)
    bare = tb.scene_from_triangles_txt(BOX_SCENE, include_default_spheres=False).to(dev)
    tt, n_live = tb.tessellate(box.triangles, box.n_triangles, levels=3)
    x3 = dataclasses.replace(box, triangles=tt, n_triangles=n_live,
                             accel=None).with_accel()
    with knobs_set({"RTC_RESOLVE": "perm"}):
        perm = with_perm_resolve(x3)
    scenes = {"sphere": box, "no sphere": bare, "perm": perm}
    if perm.resolve_perm is None:
        raise AssertionError("shade: no Morton-permuted resolve table attached")
    for name, sc in scenes.items():  # no table is copied on a launch
        if shade._scene_args(sc, dev)[2]:
            raise AssertionError(f"shade {name}: a scene table is not contiguous")
        if not shade.kernel_route(sc, sc.triangles.a):
            raise AssertionError(f"shade {name}: not on the kernel route")

    def same(label, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            a = a.view(torch.int32) if a.is_floating_point() else a
            b = b.view(torch.int32) if b.is_floating_point() else b
            if not torch.equal(a, b):
                diff = (a != b).reshape(a.shape[0], -1).any(1)
                raise AssertionError(f"shade {label}: output {k} differs from the "
                                     f"plain version on {int(diff.sum())} of "
                                     f"{diff.numel()} lanes")

    def hit_fields(h):
        return [getattr(h, f.name) for f in dataclasses.fields(h)]

    cases = calls = 0
    launches = shade.shade_kernel.launches
    for n in SHADE_LANES:
        for name, sc in scenes.items():
            if name == "perm" and n not in SHADE_PERM_LANES:
                continue
            x = shade_inputs(np_rng, n, dev)
            walk = (x["pos"], x["d"], x["thr"], x["light"], x["state"])
            for alive in (None, x["alive"]):
                label = f"{name}, {n} lanes, {'dead lanes' if alive is not None else 'all alive'}"
                ref = nearest_hit(x["pos"], x["d"], sc, alive=alive)
                same(f"bounce {label}",
                     shade.shade_kernel("bounce", *walk, ref, alive, sc),
                     shade.bounce_plain(*walk, ref, alive, sc))
                hit = resolve_hit(x["pos"], x["d"], ref, sc)
                same(f"step {label}", shade.shade_kernel("step", *walk, hit, alive, sc),
                     shade.step_plain(*walk, hit, alive, sc))
                act = torch.ones_like(x["alive"]) if alive is None else alive
                (kh, kl), (ph, pl) = (
                    shade.shade_kernel("primary", x["pos"], x["d"], ref, act, sc),
                    shade.primary_plain(x["pos"], x["d"], ref, act, sc))
                same(f"primary {label}", hit_fields(kh) + [kl], hit_fields(ph) + [pl])
                for group in (1, 2):
                    w = n // group
                    sid = (2**32 + 3 if group == 1 else
                           torch.arange(group, device=dev).repeat_interleave(w) + 2**32 + 3)
                    args = (2**31 + 11, torch.arange(w * group, device=dev) * 5 + 2**33,
                            sid, hit.normal[:w * group], hit.smoothness[:w * group, None],
                            x["d"][:w * group], hit.albedo[:w * group].amax(dim=-1), sc)
                    same(f"open group {group} {label}", shade.shade_kernel("open", *args),
                         shade.open_plain(*args))
                    calls += w > 0
                cases += 1
                calls += 3
    torch.cuda.synchronize()
    if shade.shade_kernel.launches - launches != calls:
        raise AssertionError(f"shade: {shade.shade_kernel.launches - launches} "
                             f"launches for {calls} kernel calls with lanes")

    # A whole frame on each route.
    cam = Camera.look_at()
    before, launches = dict(COUNTS), shade.shade_kernel.launches
    img_k, n_k = render(box, cam, **run)
    torch.cuda.synchronize()
    launches = shade.shade_kernel.launches - launches
    k_lanes = {k: COUNTS[k] - before[k] for k in ("shade.kernel_lanes", "shade.torch_lanes")}
    albedo = box.triangles.albedo.clone().requires_grad_(True)
    before = dict(COUNTS)
    img_t, n_t = render(with_leaves(box, {".triangles.albedo": albedo}), cam,
                        early_exit=False, **run)
    torch.cuda.synchronize()
    t_lanes = {k: COUNTS[k] - before[k] for k in ("shade.kernel_lanes", "shade.torch_lanes")}
    if k_lanes["shade.torch_lanes"] or not k_lanes["shade.kernel_lanes"]:
        raise AssertionError(f"shade frame: the production frame's lanes {k_lanes}")
    if t_lanes["shade.kernel_lanes"] or not t_lanes["shade.torch_lanes"]:
        raise AssertionError(f"shade frame: the grad frame's lanes {t_lanes}")
    img_t = img_t.detach()
    if n_k != n_t or not torch.equal(img_k.view(torch.int32), img_t.view(torch.int32)):
        raise AssertionError(f"shade frame: kernel route {n_k} rays, torch route {n_t}; "
                             f"{int((img_k != img_t).any(-1).sum())} pixels differ")
    frame = {"rays": n_k, "lanes": k_lanes["shade.kernel_lanes"],
             "mean": float(img_k.mean()), "launches": launches}
    del img_t, albedo
    torch.cuda.empty_cache()

    # The bounce entry at a loop's width: kernel, host, device, plain, bound.
    x = shade_inputs(np_rng, SHADE_TIMED, dev)
    walk = (x["pos"], x["d"], x["thr"], x["light"], x["state"])
    ref = nearest_hit(x["pos"], x["d"], box)
    timed = split_times(lambda: shade.shade_kernel("bounce", *walk, ref, None, box),
                        "shade_kernel")
    timed["plain"] = cuda_ms(lambda: shade.bounce_plain(*walk, ref, None, box), 20)
    timed["bytes"] = SHADE_TIMED * SHADE_LANE_BYTES
    timed["bound"] = bound(0, 0, timed["bytes"])
    # The host time a call that the route test and the scene's table
    # pointers take, in us (the pointers built anew and reused).
    per_call = lambda fn: min(timeit.repeat(fn, number=SHADE_HOST_CALLS,
                                            repeat=5)) / SHADE_HOST_CALLS * 1e6
    host = {"route": per_call(lambda: shade.kernel_route(box, *walk[:4])),
            "tables": per_call(lambda: shade._scene_tables(box, dev)),
            "tables reused": per_call(lambda: shade._scene_args(box, dev))}
    return {"cases": cases, "frame": frame, "timed": timed, "host": host,
            "report": _build.ptxas_report("shade_kernel")}


def cull_scene(rng, kind: str, n_live: int):
    """``(Triangles, n_live, ray origin box)`` of a phase-3g case."""
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    if kind == "tetra":
        scene = scene_from_triangles_txt(TETRA_SCENE)
        return scene.triangles, scene.n_triangles, ((-70.0,) * 3, (70.0,) * 3)
    return packet_scene(rng, kind, n_live)


def special_lanes(o, d):
    """Copies of ``o, d`` with NaN, infinite, zero, -0.0 and +-1e-21
    components in some lanes."""
    o, d = o.clone(), d.clone()
    nan, inf = float("nan"), float("inf")
    o[::97, 0] = nan
    d[1::89, 1] = nan
    o[2::83, 2] = inf
    d[3::79, 0] = -inf
    d[4::73] = 0.0
    d[5::71, 1] = -0.0
    d[6::67, 2] = 1e-21
    d[7::61, 0] = -1e-21
    d[8::59, 1] = inf
    return o, d


def card_words(where, entry, o, d, alive, accel, accel_cpu, *args):
    """``entry(o, d, alive, accel, *args)``, a word route's culling entry, on
    the card: one launch of cull_words, held bit for bit to the same entry on
    CPU copies of its inputs (``accel_cpu``, the accel on the CPU), which is
    the kernel's plain version. Returns the card's words (and union flags);
    raises on any disagreement."""
    import torch

    from raytracingc_tpu_torch.ops import culling

    launches = culling.cull_words.launches
    got = entry(o, d, alive, accel, *args)
    n = culling.cull_words.launches - launches
    if n != 1:
        raise AssertionError(f"{where}: {n} launches of cull_words, expected 1")
    want = entry(o.cpu(), d.cpu(), None if alive is None else alive.cpu(),
                 accel_cpu, *args)
    for g, w in zip(*((x,) if torch.is_tensor(x) else x for x in (got, want))):
        if g.shape != w.shape or not torch.equal(g.cpu(), w):
            bad = int((g.cpu() != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"{where}: words differ from the plain version "
                                 f"on a CPU copy ({bad} words)")
    return got


def check_cull_kernel(dev, rng) -> dict:
    """Phase 3g. Returns ``{"cases": n, "notes": [...], "timed": {label:
    split_times + plain, host and bound}}``; raises on any disagreement."""
    import torch

    from raytracingc_tpu_torch.camera import Camera, primary_rays
    from raytracingc_tpu_torch.ops import culling, search
    from raytracingc_tpu_torch.ops.accel import BLOCK, build_accel
    from raytracingc_tpu_torch.tools import cuda_ms, knobs_set, split_times
    from raytracingc_tpu_torch.tools.packets import packet_rays, secondary_rays

    import numpy as np

    cases, notes, timed = 0, [], {}
    for label, kind, n_live, env in CULL_CASES:
        tris, n, (lo, hi) = cull_scene(rng, kind, n_live)
        tris = tris.to(dev)
        accel = build_accel(tris, n)
        accel_cpu = accel.to("cpu")
        with knobs_set(env):
            way = search.route(n, accel.n_blocks, search.Knobs.read())
        if not label.startswith(way.tpu + " "):
            raise AssertionError(f"{label}: routed to {way}")
        tiles = (way.n_tiles, way.tile // BLOCK, way.granule)
        entry, args = {
            "bitmask": (culling.packet_block_masks, ()),
            "mxu": (culling.program_union_words, ()),
            "packed": (culling.packet_tile_words_multi, tiles),
            "words": (culling.packet_tile_words, tiles),
        }[way.kernel]
        nonzero = []
        for n_rays in CULL_RAYS:
            o, d, alive = (torch.from_numpy(x).to(dev)
                           for x in packet_rays(rng, n_rays, lo, hi))
            so, sd, salive = (torch.from_numpy(x).to(dev)
                              for x in secondary_rays(rng, n_rays, lo, hi))
            po, pd = special_lanes(o, d)
            for name, (ro, rd, ra) in (("coherent", (o, d, alive)),
                                       ("secondary", (so, sd, salive)),
                                       ("alive=None", (o, d, None)),
                                       ("special values", (po, pd, alive))):
                got = card_words(f"{label} R={n_rays} {name}", entry, ro, rd, ra,
                                 accel, accel_cpu, *args)
                if way.kernel == "mxu":
                    got = torch.cat([got[0], got[1][:, None]], 1)
                nonzero.append(int((got != 0).sum()))
                cases += 1
        if not all(nonzero[:2]):
            raise AssertionError(f"{label}: no culling bit set: {nonzero}")
        notes.append(f"{label} ({way.kernel}, {accel.n_blocks} blocks, words "
                     f"{tuple(got.shape)}): nonzero words {nonzero}")
        if label != CULL_TIMED:
            continue
        cam = Camera.look_at(device=dev, **TETRA_CAMERA)
        po, pd = primary_rays(cam, 1920, 1080)
        mid = (po.shape[0] - CULL_TIMED_RAYS[0]) // 2
        for n_rays in CULL_TIMED_RAYS:
            if n_rays == CULL_TIMED_RAYS[0]:
                tag = f"primary R={n_rays}"
                ro, rd = po[mid:mid + n_rays].contiguous(), pd[mid:mid + n_rays].contiguous()
                ra = torch.ones((n_rays,), dtype=torch.bool, device=dev)
            else:
                tag = f"secondary R={n_rays}"
                ro, rd, ra = (torch.from_numpy(x).to(dev)
                              for x in secondary_rays(rng, n_rays, lo, hi))
            call = lambda: culling.packet_block_masks(ro, rd, ra, accel)
            plain = lambda: culling.cull_words_reference(ro, rd, ra, accel.aabb_lo,
                                                         accel.aabb_hi)
            if not torch.equal(call(), plain()):
                raise AssertionError(f"{label} {tag}: words differ from the plain version")
            t = split_times(call, "cull_words_kernel")
            t["plain"] = cuda_ms(plain, 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                plain()
            t["plain host"] = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            live = int(ra.sum())
            words = -(-n_rays // 8) * -(-accel.n_blocks // 31)
            t["bound"] = bound(live * (accel.n_blocks * CULL_SLAB_OPS + CULL_RAY_OPS), 0,
                               n_rays * (24 + 1) + 4 * words + 24 * accel.n_blocks)
            t["live"] = live
            t["nonzero"] = int((call() != 0).sum())
            timed[tag] = t
    return {"cases": cases, "notes": notes, "timed": timed}


def compact_lanes(gen, n: int, live: float, dev) -> dict:
    """A seeded compaction's inputs on the card: a bounce's lane ids
    (ascending, spread over an image of 2n + 1 rows), pos, d, thr, light
    [n, 3], states, smoothness [n], the mask (the share ``live`` set) and
    the image."""
    import numpy as np
    import torch

    f32 = lambda *s: torch.from_numpy(gen.normal(size=s).astype(np.float32)).to(dev)
    return dict(
        ids=torch.from_numpy(np.sort(gen.choice(2 * n + 1, n, replace=False))).to(dev),
        pos=f32(n, 3), d=f32(n, 3), thr=f32(n, 3), light=f32(n, 3),
        state=torch.from_numpy(gen.integers(0, 2**32, n, dtype=np.int64)).to(dev),
        smooth=f32(n), mask=torch.from_numpy(gen.random(n) < live).to(dev),
        image=f32(2 * n + 1, 3))


def check_compact_kernel(dev, gen) -> dict:
    """Phase 3h. Returns ``{"cases", "burst", "frames", "timed", "report"}``;
    raises on any disagreement."""
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.ops import _build, compact, shade
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.tools import cuda_ms, split_times
    from raytracingc_tpu_torch.utils.profiling import COUNTS
    from portbench.lib.traffic import camera_fov, program_scene

    def junk(like, n):
        return [torch.full((n + 3, *t.shape[1:]), -7, dtype=t.dtype, device=dev)
                for t in like]

    def same(label, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            if not _same_bits(a, b):
                raise AssertionError(f"compact {label}: output {k} differs from the "
                                     f"plain version ({tuple(a.shape)} against "
                                     f"{tuple(b.shape)})")

    def bounce_args(x):
        payload = [x[k] for k in ("pos", "d", "thr", "state", "light")]
        return payload, junk(payload, x["mask"].numel())

    def entry_args(x):
        payload = [x["pos"], x["state"], x["smooth"]]
        return payload, junk(payload, x["mask"].numel())

    cases, launches = 0, compact.compact_kernel.launches
    for n in COMPACT_LANES:
        for live in COMPACT_DENSITIES:
            x = compact_lanes(gen, n, live, dev)
            label = f"{n} lanes, {live:.0%} live"
            for kind, (payload, outs) in (("bounce", bounce_args(x)),
                                          ("entry", entry_args(x))):
                ids = x["ids"] if kind == "bounce" else None
                img_k, img_p = x["image"].clone(), x["image"].clone()
                wb = lambda img: (x["light"], img) if kind == "bounce" else None
                lanes_k, got = compact.compact_kernel(
                    x["mask"], ids, payload, outs, junk([x["ids"]], n)[0], wb(img_k))
                outs_p = junk(payload, n)
                lanes_p = junk([x["ids"]], n)[0]
                m = compact.compact_reference(x["mask"], ids, payload, outs_p, lanes_p,
                                              wb(img_p))
                if lanes_k.numel() != m or m != int(x["mask"].sum()):
                    raise AssertionError(f"compact {kind} {label}: {lanes_k.numel()} "
                                         f"lanes kept, the plain version {m}")
                same(f"{kind} {label}", [lanes_k, *got, img_k],
                     [lanes_p[:m], *(o[:m] for o in outs_p), img_p])
                cases += 1
    torch.cuda.synchronize()
    if compact.compact_kernel.launches - launches != 2 * len(COMPACT_LANES) * len(
            COMPACT_DENSITIES):
        raise AssertionError(f"compact: {compact.compact_kernel.launches - launches} "
                             f"launches for {cases} cases")

    # Launches back to back: the status words' epochs and the tickets.
    inputs = [compact_lanes(gen, n, COMPACT_DENSITIES[k % len(COMPACT_DENSITIES)], dev)
              for k, n in enumerate(COMPACT_BURST_LANES)]
    wants = [torch.nonzero(x["mask"]).squeeze(1) for x in inputs]
    bufs = [entry_args(x)[1] for x in inputs]
    out_lanes = torch.empty(max(COMPACT_BURST_LANES), dtype=torch.int64, device=dev)
    for i in range(COMPACT_BURST):
        k = i % len(inputs)
        x = inputs[k]
        lanes, (pos, _, _) = compact.compact_kernel(x["mask"], None, entry_args(x)[0],
                                                    bufs[k], out_lanes)
        if not (torch.equal(lanes, wants[k]) and torch.equal(pos, x["pos"][wants[k]])):
            raise AssertionError(f"compact burst: launch {i} ({x['mask'].numel()} "
                                 f"lanes) differs from torch.nonzero")
    burst = {"launches": COMPACT_BURST, "lanes": COMPACT_BURST_LANES}

    # Whole frames on the kernel route, and with the compaction's route
    # forced to torch.
    w, h = COMPACT_FRAME["width"], COMPACT_FRAME["height"]
    frames = {}
    for name in COMPACT_CONFIGS:
        with open(os.path.join(HERE, "portbench", "configs", f"{name}.json")) as f:
            config = json.load(f)
        scene, cc = program_scene(config, dev), config["camera"]
        cam = Camera.look_at(origin=cc["origin"], target=cc["look_at"],
                             fov=camera_fov(cc, w, h), device=dev)
        runs = {}
        for route in ("kernel", "torch"):
            before = dict(COUNTS)
            counts = (compact.compact_kernel.launches, shade.shade_kernel.launches)
            real = compact.route
            if route == "torch":
                compact.route = lambda scene, *tensors: False
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                img, rays = render(scene, cam, **COMPACT_FRAME, seed=COMPACT_SEED)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            finally:
                compact.route = real
            runs[route] = dict(
                img=img, rays=rays, wall=wall,
                lanes={k: COUNTS[k] - before[k] for k in ("compact.kernel_lanes",
                                                          "compact.torch_lanes")},
                compact=compact.compact_kernel.launches - counts[0],
                shade=shade.shade_kernel.launches - counts[1])
        k, t_ = runs["kernel"], runs["torch"]
        if not (k["compact"] and k["lanes"]["compact.kernel_lanes"]
                and not k["lanes"]["compact.torch_lanes"]):
            raise AssertionError(f"compact {name} frame: kernel route {k['lanes']}, "
                                 f"{k['compact']} launches")
        if t_["compact"] or t_["lanes"]["compact.kernel_lanes"] or not t_["shade"]:
            raise AssertionError(f"compact {name} frame: torch route {t_['lanes']}, "
                                 f"{t_['compact']} launches, {t_['shade']} shade_kernel")
        if k["rays"] != t_["rays"] or not _same_bits(k["img"], t_["img"]):
            raise AssertionError(f"compact {name} frame: kernel route {k['rays']} rays, "
                                 f"torch route {t_['rays']}; "
                                 f"{int((k['img'] != t_['img']).any(-1).sum())} pixels "
                                 f"differ")
        frames[name] = dict(rays=k["rays"], mean=float(k["img"].mean()),
                            launches=k["compact"], lanes=k["lanes"]["compact.kernel_lanes"],
                            wall=k["wall"], torch_wall=t_["wall"])
    torch.cuda.empty_cache()

    # A bounce's compaction at a loop's width: kernel (events, host a call,
    # device), the torch compaction it replaces, the bytes bound.
    x = compact_lanes(gen, COMPACT_TIMED, COMPACT_TIMED_LIVE, dev)
    payload, outs = bounce_args(x)
    lanes_buf = torch.empty(COMPACT_TIMED, dtype=torch.int64, device=dev)
    image = x["image"].clone()
    call = lambda: compact.compact_kernel(x["mask"], x["ids"], payload, outs,
                                          lanes_buf, (x["light"], image))

    def torch_chain():  # the loop's compaction as it stood before the kernel
        keep = torch.nonzero(x["mask"]).squeeze(1)
        full = x["image"].index_copy(0, x["ids"], x["light"])
        return full, [t[keep] for t in (x["ids"], *payload, x["mask"])]

    timed = split_times(call, "compact_kernel")
    timed["plain"] = cuda_ms(torch_chain, 20)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        torch_chain()
    timed["plain host"] = (time.perf_counter() - t) / 200 * 1e3
    torch.cuda.synchronize()
    m = int(x["mask"].sum())
    row = sum(t[0].numel() * t.element_size() for t in payload)  # 56 bytes
    # Read: every mask byte and id; the live lanes' rows; the dead lanes'
    # radiance. Written: the live lanes' ids and rows; the dead lanes'
    # radiance.
    timed["bytes"] = (COMPACT_TIMED * (1 + 8) + m * (row + 8 + row)
                      + (COMPACT_TIMED - m) * 2 * 12)
    timed["bound"] = bound(0, 0, timed["bytes"])
    timed["live"] = m
    return {"cases": cases, "burst": burst, "frames": frames, "timed": timed,
            "report": _build.ptxas_report("compact_kernel")}


def check_modes(dev, run=MODES_RUN) -> dict:
    """Phase 6. Returns ``{mode: (seconds, traced rays, search_brute
    launches)}``; raises on a broken identity."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.ops.search_brute import search_brute
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    scene = scene_from_triangles_txt(BOX_SCENE).to(dev)
    cam = Camera.look_at(device=dev)
    modes = {"production": dict(early_exit=True),
             "differentiable": dict(early_exit=False),
             "sample_group 2": dict(early_exit=False, sample_group=2),
             "sample_group auto": dict(early_exit=True, sample_group="auto"),
             "oracle (compact=False)": dict(early_exit=False, compact=False),
             **{f"sample_batch {sb}{' differentiable' if not ee else ''}":
                dict(early_exit=ee, sample_batch=sb)
                for ee in (True, False) for sb in (2, 4, "auto")}}
    out, imgs = {}, {}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    with torch.no_grad():
        for label, kw in modes.items():
            search_brute.launches = 0
            t = time.time()
            img, n = render(scene, cam, **run, **kw)
            sync()
            out[label] = (time.time() - t, n, search_brute.launches)
            imgs[label] = img
            if dev.type == "cuda" and search_brute.launches < 1:
                raise AssertionError(f"modes {label}: search_brute never launched")
    prod, n = imgs["production"], out["production"][1]
    for label, img in imgs.items():
        if out[label][1] != n:
            raise AssertionError(f"modes {label}: {out[label][1]} traced rays, "
                                 f"production {n}")
        if label.startswith(("oracle", "sample_batch")):
            np.testing.assert_allclose(img.cpu().numpy(), prod.cpu().numpy(),
                                       **REASSOC)
        elif not torch.equal(img.view(torch.int32), prod.view(torch.int32)):
            raise AssertionError(f"modes {label}: not production's bits")

    # sample_batch "auto" on the packet route (K2).
    from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask

    big = train_scene(dev, SB_K2_TESSELLATE)
    k2 = {}
    with torch.no_grad():
        for label, kw in (("production", {}), ("sample_batch auto", dict(
                sample_batch="auto"))):
            search_bitmask.launches = 0
            t = time.time()
            img, n = render(big, cam, **run, **kw)
            sync()
            k2[label] = (img, n, time.time() - t, search_bitmask.launches)
    (k2_prod, k2_n, *_), (k2_img, k2_m, *_) = k2.values()
    if k2_m != k2_n or (dev.type == "cuda" and min(v[3] for v in k2.values()) < 1):
        raise AssertionError(f"modes K2: {k2_m} traced rays against production's "
                             f"{k2_n}, K2 launches {[v[3] for v in k2.values()]}")
    np.testing.assert_allclose(k2_img.cpu().numpy(), k2_prod.cpu().numpy(), **REASSOC)
    for label, (_, n, sec, launches) in k2.items():
        out[f"{label}, {big.n_triangles} triangles"] = (sec, n, launches)
    return out


def time_sample_batch(dev, run=SB_RUN, rounds=SB_ROUNDS) -> dict:
    """Phase 6's timing: ``{variant: (walls, traced rays, search_brute
    launches per frame)}`` over ``rounds`` alternating rounds; raises on a
    broken identity."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.ops.search_brute import search_brute
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    scene = scene_from_triangles_txt(BOX_SCENE).to(dev)
    cam = Camera.look_at(device=dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    out = {k: ([], None, None) for k in SB_TIMED}
    imgs = {}
    order = list(SB_TIMED)
    with torch.no_grad():
        for r in range(rounds):  # round 0's images are checked
            for label in (order if r % 2 == 0 else order[::-1]):
                search_brute.launches = 0
                sync()
                t = time.time()
                img, n = render(scene, cam, **run, **SB_TIMED[label])
                sync()
                sec = time.time() - t
                walls, n0, k0 = out[label]
                if r == 0:
                    imgs[label] = img
                    n0, k0 = n, search_brute.launches
                    out[label] = (walls, n0, k0)
                if (n, search_brute.launches) != (n0, k0):
                    raise AssertionError(f"sample_batch timing {label}: round {r} "
                                         f"traced {n} rays with {search_brute.launches}"
                                         f" K1 launches, round 0 {n0} with {k0}")
                walls.append(sec)
    one, n1 = imgs["sample_batch 1"], out["sample_batch 1"][1]
    if any(v[1] != n1 for v in out.values()):
        raise AssertionError(f"sample_batch timing: traced rays "
                             f"{ {k: v[1] for k, v in out.items()} }")
    np.testing.assert_allclose(imgs["sample_batch 8"].cpu().numpy(),
                               one.cpu().numpy(), **REASSOC)
    for a, b in (("sample_batch auto", "sample_batch 8"),
                 ("sample_group auto", "sample_batch 1")):
        if not _same_bits(imgs[a], imgs[b]):
            raise AssertionError(f"sample_batch timing: {a} is not {b}'s bits")
    return out


def train_scene(dev, tessellate=TRAIN_TESSELLATE):
    """box_scene tessellated, with its accel, as the CLI's --tessellate."""
    import dataclasses

    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt, tessellate as tess

    scene = scene_from_triangles_txt(BOX_SCENE)
    tris, n = tess(scene.triangles, scene.n_triangles, levels=tessellate)
    return dataclasses.replace(scene, triangles=tris, n_triangles=n,
                               accel=None).with_accel().to(dev)


def untie_albedo(scene, seed=FD_SEED):
    """The scene with each albedo channel scaled by U(0.94, 1) from a
    seeded generator: no two channels of a material stay equal (the
    roulette's max has a kink at tied channels, where FD straddles it and
    autodiff takes one side; tests/test_diff.py unties its scene for the
    same reason), and every albedo stays in [0, 1]."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

    rng = np.random.default_rng(seed)
    leaves = scene_leaves(scene)
    for k in (".triangles.albedo", ".spheres.albedo"):
        scale = rng.uniform(0.94, 1.0, tuple(leaves[k].shape)).astype(np.float32)
        leaves[k] = leaves[k] * torch.from_numpy(scale).to(scene.device)
    return with_leaves(scene, leaves)


def scene_grads(scene, cam, run, seed=0):
    """``({leaf: grad}, traced rays)`` of ``mean(radiance * w)`` through the
    differentiable fast forward on the scene's device; ``w`` standard normal
    from a CPU generator seeded with ``seed``."""
    import torch

    from raytracingc_tpu_torch.camera import primary_rays
    from raytracingc_tpu_torch.render.integrator import trace_accumulate
    from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

    dev = scene.device
    w_, h_ = run["width"], run["height"]
    o, d = primary_rays(cam.to(dev), w_, h_)
    w = torch.randn((w_ * h_, 3), generator=torch.Generator().manual_seed(seed))
    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, t in scene_leaves(scene).items()}
    rad, n = trace_accumulate(o, d, with_leaves(scene, leaves),
                              torch.arange(w_ * h_, device=dev), seed=seed,
                              spp=run["spp"], max_bounce=run["max_bounce"])
    (rad * w.to(dev)).mean().backward()
    return {k: (t.grad if t.grad is not None else torch.zeros_like(t)).cpu()
            for k, t in leaves.items()}, n


def run_training(dev, run=TRAIN, steps=TRAIN_STEPS, tessellate=TRAIN_TESSELLATE):
    """Run (q)'s training: fit_scene on the albedo, on geometry (the accel
    refreshed every step) and fit_camera, ``steps`` each. Returns ``{name:
    (losses, seconds, search_bitmask launches)}`` and the forward and
    backward seconds of one albedo step, timed apart; raises on a non-finite or (albedo) not
    falling loss, or a differentiable forward other than production's
    bits."""
    import dataclasses

    import torch

    from raytracingc_tpu_torch.camera import Camera, primary_rays
    from raytracingc_tpu_torch.diff import fit_camera, fit_scene
    from raytracingc_tpu_torch.ops.compact import compact_kernel
    from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
    from raytracingc_tpu_torch.ops.shade import shade_kernel
    from raytracingc_tpu_torch.render.integrator import trace_accumulate
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    scene = train_scene(dev, tessellate)
    cam = Camera.look_at(device=dev)
    shape = dict(spp=run["spp"], max_bounce=run["max_bounce"])
    with torch.no_grad():
        target, _ = render(scene, cam, run["width"], run["height"], **shape)
    leaves = scene_leaves(scene)
    leaves[".triangles.albedo"] = leaves[".triangles.albedo"] * 0.5
    dim = with_leaves(scene, leaves)

    # One step timed apart, after one untimed: the forward under autograd
    # (its values are production's bits), then the backward.
    o, d = primary_rays(cam, run["width"], run["height"])
    ids = torch.arange(run["width"] * run["height"], device=dev)
    params = {k: t.detach().clone().requires_grad_(k == ".triangles.albedo")
              for k, t in scene_leaves(dim).items()}
    for _ in range(2):
        sync()
        t = time.time()
        rad, _ = trace_accumulate(o, d, with_leaves(dim, params), ids, seed=0, **shape)
        loss = ((rad - target.reshape(-1, 3)) ** 2).mean()
        sync()
        t_fwd = time.time() - t
        t = time.time()
        loss.backward()
        sync()
        t_bwd = time.time() - t
    with torch.no_grad():
        prod, _ = trace_accumulate(o, d, dim, ids, seed=0, early_exit=True, **shape)
    if not torch.equal(rad.detach().view(torch.int32), prod.view(torch.int32)):
        raise AssertionError("run q: the differentiable forward under autograd is "
                             "not production's bits")

    out, fitted = {}, {}
    fits = {
        "albedo": lambda **kw: fit_scene(dim, target, cam, learning_rate=5e-2,
                                         trainable=["albedo"], **shape, **kw),
        "geometry": lambda **kw: fit_scene(scene, target * 0.9, cam,
                                           learning_rate=1e-3,
                                           trainable=TRAIN_GEOMETRY, **shape, **kw),
        "camera": lambda **kw: fit_camera(scene, target, dataclasses.replace(
            cam, origin=cam.origin + torch.tensor([0.12, -0.08, 0.1], device=dev)),
            learning_rate=1e-3, **shape, **kw),
        # The geometry run again, its accel re-sorted every 2 steps: the run
        # that a resume must continue on the accel it had.
        "geometry, accel_rebuild_every=2": lambda **kw: fit_scene(
            scene, target * 0.9, cam, learning_rate=1e-3, trainable=TRAIN_GEOMETRY,
            accel_rebuild_every=2, **shape, **kw),
    }

    def timed(name, fit, **kw):
        sync()
        k2, shaded = search_bitmask.launches, shade_kernel.launches
        compacted = compact_kernel.launches
        t = time.time()
        result, losses = fit(**kw)
        sync()
        out[name] = (losses, time.time() - t, search_bitmask.launches - k2)
        # A fit's steps take the torch route.
        if shade_kernel.launches != shaded or compact_kernel.launches != compacted:
            raise AssertionError(f"run q {name}: shade_kernel launched "
                                 f"{shade_kernel.launches - shaded} times, "
                                 f"compact_kernel {compact_kernel.launches - compacted}")
        return result

    for name, fit in fits.items():
        fitted[name] = timed(name, fit, steps=steps)
    albedo = out["albedo"][0]
    if not albedo[-1] < albedo[0]:
        raise AssertionError(f"run q: the albedo loss did not fall: {albedo}")

    # Checkpoints: TRAIN_RESUME_AT steps with a checkpoint, then resumed from
    # it to `steps`: the resumed losses, the fitted leaves and the fitted
    # accel equal the uninterrupted run's bit for bit.
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("albedo", "geometry, accel_rebuild_every=2"):
            ck = os.path.join(tmp, "fit.npz")
            timed(f"{name}, first {TRAIN_RESUME_AT}", fits[name],
                  steps=TRAIN_RESUME_AT, checkpoint_path=ck)
            resumed = timed(f"{name}, resumed", fits[name], steps=steps,
                            checkpoint_path=ck)
            first = out[f"{name}, first {TRAIN_RESUME_AT}"][0]
            rest = out[f"{name}, resumed"][0]
            if first + rest != out[name][0] or len(rest) != steps - TRAIN_RESUME_AT:
                raise AssertionError(f"run q {name}: losses {first} + {rest} "
                                     f"against {out[name][0]}")
            whole = fitted[name]
            for k, v in scene_leaves(whole).items():
                if not torch.equal(scene_leaves(resumed)[k].view(torch.int32),
                                   v.view(torch.int32)):
                    raise AssertionError(f"run q {name}: the resumed {k} is not "
                                         f"the uninterrupted run's bits")
            for f in ("orig_idx", "aabb_lo", "aabb_hi", "packed_plane"):
                if not torch.equal(getattr(resumed.accel, f), getattr(whole.accel, f)):
                    raise AssertionError(f"run q {name}: the resumed accel's {f} "
                                         f"differs")
            os.unlink(ck)
    return out, t_fwd, t_bwd


def kernel_counters() -> dict:
    """Every kernel wrapper by name; each counts its own launches."""
    from raytracingc_tpu_torch.ops.intersect_mxu import search_mxu
    from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
    from raytracingc_tpu_torch.ops.search_brute import search_brute
    from raytracingc_tpu_torch.ops.search_packed import search_packed
    from raytracingc_tpu_torch.ops.search_range import search_range
    from raytracingc_tpu_torch.ops.search_union import search_union
    from raytracingc_tpu_torch.ops.search_words import search_words
    from raytracingc_tpu_torch.ops.compact import compact_kernel
    from raytracingc_tpu_torch.ops.shade import shade_kernel
    from raytracingc_tpu_torch.tools import smem_probe

    return {"search_brute": search_brute, "search_bitmask": search_bitmask,
            "search_packed": search_packed, "search_range": search_range,
            "search_words": search_words, "search_mxu": search_mxu,
            "search_union": search_union, "smem_probe": smem_probe.smem_probe,
            "shade_kernel": shade_kernel, "compact_kernel": compact_kernel}


def _same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _step_grads(scene, cam, target, run, mesh):
    """One make_train_step SGD step of every leaf of ``scene`` against
    ``target`` on ``mesh`` (None: one device): ``(loss, {leaf: gradient}
    on the host)``."""
    import torch

    from raytracingc_tpu_torch.camera import primary_rays
    from raytracingc_tpu_torch.parallel import make_train_step
    from raytracingc_tpu_torch.scene.types import scene_leaves

    w, h = run["width"], run["height"]
    o, d = primary_rays(cam, w, h)
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in scene_leaves(scene).items()}
    opt = torch.optim.SGD(list(params.values()), lr=PARALLEL_LR)
    step = make_train_step(mesh, opt, spp=run["spp"], max_bounce=run["max_bounce"])
    _, loss = step(scene, params, o, d, torch.arange(w * h, device=o.device), target)
    return loss, {k: t.grad.cpu() for k, t in params.items()}


def _train_target(scene, cam, run):
    """Run (q)'s scene rendered in production mode, dimmed by 0.9 (so that
    every pixel's residual is a real one), as ``[R, 3]``."""
    import torch

    from raytracingc_tpu_torch.render.renderer import render

    with torch.no_grad():
        img, _ = render(scene, cam, **run)
    return img.reshape(-1, 3) * 0.9


def run_parallel_one_rank(dev, run=PARALLEL, train=TRAIN,
                          tessellate=PARALLEL_TESSELLATE) -> dict:
    """Run (v) in this process. Returns ``{label: (seconds, traced rays or
    loss)}``; raises on a broken identity."""
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.ops.shade import shade_kernel
    from raytracingc_tpu_torch.parallel import (
        make_mesh,
        pad_scene_for_blocks,
        render_sharded,
    )
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    out = {}

    def timed(label, fn):
        sync()
        t = time.time()
        img, n = fn()
        sync()
        out[label] = (time.time() - t, n)
        return img, n

    cam = Camera.look_at(device=dev)
    with torch.no_grad():
        box = scene_from_triangles_txt(BOX_SCENE).to(dev)
        want, n = timed("render", lambda: render(box, cam, **run))
        for strategy in ("pixels", "samples", "both"):
            img, m = timed(f"render_sharded {strategy}", lambda: render_sharded(
                box, cam, **run, strategy=strategy))
            if m != n or not _same_bits(img, want):
                raise AssertionError(f"run v: render_sharded({strategy!r}) is not "
                                     f"render's bits ({m} against {n} rays)")
        big = train_scene(dev, tessellate)
        want, n = timed(f"render --tessellate {tessellate}",
                        lambda: render(big, cam, **run))
        img, m = timed("render_sharded blocks", lambda: render_sharded(
            pad_scene_for_blocks(big, 1), cam, **run, scene_sharding="blocks"))
        if m != n or not _same_bits(img, want):
            raise AssertionError(f"run v: the block-sharded render is not the "
                                 f"replicated render's bits ({m} against {n} rays)")
    scene = train_scene(dev)
    target = _train_target(scene, cam, train)
    shaded = shade_kernel.launches
    t = time.time()
    loss, grads = _step_grads(scene, cam, target, train, None)
    out["train step"] = (time.time() - t, loss)
    t = time.time()
    mesh_loss, mesh_grads = _step_grads(scene, cam, target, train,
                                        make_mesh(1, 1, device_type=dev.type))
    out["train step, one-rank mesh"] = (time.time() - t, mesh_loss)
    if shade_kernel.launches != shaded:
        raise AssertionError(f"run v: the train steps launched shade_kernel "
                             f"{shade_kernel.launches - shaded} times")
    if mesh_loss != loss or not all(_same_bits(mesh_grads[k], g)
                                    for k, g in grads.items()):
        raise AssertionError("run v: the one-rank mesh's training step is not "
                             "fit_scene's single-device step")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli_flags(device_type: str, run: dict) -> list:
    return ["--device", device_type, "--triangles", BOX_SCENE, "--profile",
            "-s", str(run["width"]), str(run["height"]), "--spp", str(run["spp"]),
            "-b", str(run["max_bounce"])]


def parallel_rank(rank: int, cfg: dict) -> int:
    """One rank of run (w), in a child process: prints one JSON object as
    its last line (seconds, traced rays, loss, and its kernels' launches in
    each of its runs: ``{"launches": {run: {kernel: n}}}``); rank 0 writes
    the CLI's BMP and ``parallel.npz`` into ``cfg["out"]``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.cli import main as cli_main
    from raytracingc_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        pad_scene_for_blocks,
        render_sharded,
    )
    from raytracingc_tpu_torch.parallel.mesh import rank_device
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    kernels = kernel_counters()
    for f in kernels.values():
        f.launches = 0
    launches = {}

    def mark(label):
        """Record the launches since the last mark under ``label``."""
        launches[label] = {k: f.launches for k, f in kernels.items()}
        for f in kernels.values():
            f.launches = 0

    device_type, run, train = cfg["device"], cfg["run"], cfg["train"]
    n = PARALLEL_RANKS
    out = {"rank": rank}
    t = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(_cli_flags(device_type, run) + [
            "--shard", "pixels", "--coordinator", f"127.0.0.1:{cfg['ports'][0]}",
            "--num-processes", str(n), "--process-id", str(rank),
            "--dist-backend", "gloo", "-o", os.path.join(cfg["out"], "px.bmp")])
    prof = re.search(r"render=([0-9.]+)s rays=(\d+)", buf.getvalue())
    if rc != 0 or (rank == 0) != (prof is not None):
        raise AssertionError(f"rank {rank}: cli exit code {rc}\n{buf.getvalue()}")
    out["cli"] = [float(prof.group(1)), int(prof.group(2))] if prof else None
    mark("cli")

    initialize_distributed(f"127.0.0.1:{cfg['ports'][1]}", n, rank, "gloo")
    dev = rank_device(device_type)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cam = Camera.look_at(device=dev)
    results = {}

    def timed(label, fn):
        sync()
        t = time.time()
        value, count = fn()
        sync()
        out[label] = [time.time() - t, count]
        results[label] = value.cpu().numpy() if torch.is_tensor(value) else value
        mark(label)

    with torch.no_grad():
        # The host's scene: each rank copies its slice to the card.
        big = train_scene(torch.device("cpu"), cfg["tessellate"])
        timed("blocks", lambda: render_sharded(
            pad_scene_for_blocks(big, n), cam, **run,
            mesh=make_mesh(n, 1, device_type=device_type), scene_sharding="blocks"))
        timed("samples", lambda: render_sharded(
            scene_from_triangles_txt(BOX_SCENE), cam, **run,
            mesh=make_mesh(1, n, device_type=device_type)))
    # Run (x) in the world: the sample-sharded render's jvp (image and
    # tangent stacked).
    box = scene_from_triangles_txt(BOX_SCENE).to(dev)
    tangents = fwd_tangents(box)

    def sharded_jvp():
        from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

        def fn(lv):
            img, c = render_sharded(with_leaves(box, lv), cam, **FWD_SMALL,
                                    mesh=make_mesh(1, n, device_type=device_type))
            return img, torch.tensor(c)

        leaves = {k: scene_leaves(box)[k] for k in tangents}
        img, dot, c = torch.func.jvp(fn, (leaves,), (tangents,), has_aux=True)
        return torch.stack([img, dot]), int(c)

    timed("jvp samples", sharded_jvp)
    scene = train_scene(dev)
    target = _train_target(scene, cam, train)
    mark("train target")
    mesh = make_mesh(n, 1, device_type=device_type)
    _step_grads(scene, cam, target, train, mesh)  # warm: autograd's first call
    t = time.time()
    loss, grads = _step_grads(scene, cam, target, train, mesh)
    out["train"] = [time.time() - t, loss]
    mark("train")
    if rank == 0:
        np.savez(os.path.join(cfg["out"], "parallel.npz"), **results,
                 **{f"grad{k}": g.numpy() for k, g in grads.items()})
    dist.destroy_process_group()
    out["launches"] = launches
    print(json.dumps(out), flush=True)
    return 0


def run_parallel_ranks(dev, tmp, cli_main, run=PARALLEL, train=TRAIN,
                       tessellate=PARALLEL_TESSELLATE) -> dict:
    """Run (w): PARALLEL_RANKS child processes of this script on ``dev``'s
    card (gloo), held against this process's single-device runs. Returns
    ``{"ranks": [each rank's JSON], label: (seconds, traced rays)}``."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
    from raytracingc_tpu_torch.scene.types import scene_leaves

    cfg = dict(ports=[_free_port(), _free_port()], out=tmp, run=run, train=train,
               tessellate=tessellate, device=dev.type)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
         json.dumps(cfg)], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(PARALLEL_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PARALLEL_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"run w: rank {r} exited {p.returncode}:\n{log[-6000:]}")
    ranks = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    out = {"ranks": ranks}

    one = os.path.join(tmp, "one.bmp")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(_cli_flags(dev.type, run) + ["-o", one])
    prof = re.search(r"render=([0-9.]+)s rays=(\d+)", buf.getvalue())
    if rc != 0 or prof is None:
        raise AssertionError(f"run w: single-device cli exit code {rc}\n{buf.getvalue()}")
    out["cli, one device"] = (float(prof.group(1)), int(prof.group(2)))
    with open(one, "rb") as f, open(os.path.join(tmp, "px.bmp"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("run w: the 2-rank --shard pixels BMP differs from "
                                 "the single-device CLI's")
    if ranks[0]["cli"][1] != out["cli, one device"][1]:
        raise AssertionError(f"run w: --shard pixels traced {ranks[0]['cli'][1]} "
                             f"rays, one device {out['cli, one device'][1]}")

    got = np.load(os.path.join(tmp, "parallel.npz"))
    cam = Camera.look_at(device=dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    with torch.no_grad():
        sync()
        t = time.time()
        want, n = render(train_scene(dev, tessellate), cam, **run)
        sync()
        out["blocks, replicated"] = (time.time() - t, n)
        if ranks[0]["blocks"][1] != n or not _same_bits(
                torch.from_numpy(got["blocks"]), want.cpu()):
            raise AssertionError("run w: the 2-rank block-sharded render is not the "
                                 "replicated render's bits")
        box = scene_from_triangles_txt(BOX_SCENE).to(dev)
        per = run["spp"] // PARALLEL_RANKS
        parts = [render(box, cam, **{**run, "spp": per}, sample_offset=k * per)
                 for k in range(PARALLEL_RANKS)]
        want = sum(img for img, _ in parts) / float(PARALLEL_RANKS)
        if ranks[0]["samples"][1] != sum(c for _, c in parts) or not _same_bits(
                torch.from_numpy(got["samples"]), want.cpu()):
            raise AssertionError("run w: the spp-sharded render is not the mean of "
                                 "the offset renders")
    # Run (x) in the world: the mean of the one-device jvps of the offset
    # renders, image and tangent.
    per = FWD_SMALL["spp"] // PARALLEL_RANKS
    tangents = fwd_tangents(box)
    parts = [jvp_render(box, cam, tangents, "func",
                        **{**FWD_SMALL, "spp": per}, sample_offset=k * per)
             for k in range(PARALLEL_RANKS)]
    want = torch.stack([sum(p[i] for p in parts) / float(PARALLEL_RANKS)
                        for i in range(2)])
    if ranks[0]["jvp samples"][1] != sum(p[2] for p in parts) or not _same_bits(
            torch.from_numpy(got["jvp samples"]), want.cpu()):
        raise AssertionError("run w: the spp-sharded jvp (image, tangent) is not "
                             "the mean of the offset renders' jvps")
    scene = train_scene(dev)
    loss, grads = _step_grads(scene, cam, _train_target(scene, cam, train), train,
                              None)
    rel = {k: float((torch.from_numpy(got[f"grad{k}"]) - g).norm() / g.norm())
           for k, g in grads.items() if float(g.norm()) > 0}
    loss_rel = abs(ranks[0]["train"][1] - loss) / loss
    worst = max(rel, key=rel.get)
    if rel[worst] > PARALLEL_GRAD_REL or loss_rel > PARALLEL_GRAD_REL:
        raise AssertionError(f"run w: the 2x1 step's gradients against one "
                             f"device's: {rel}, loss {loss_rel:.3g}")
    out["train"] = (worst, rel[worst], loss_rel, len(scene_leaves(scene)))
    return out


def fwd_tangents(scene, seed=FWD_SEED) -> dict:
    """Run (x)'s tangents: ones on the triangles' albedo and emission, a
    seeded standard normal on vertex a."""
    import numpy as np
    import torch

    from raytracingc_tpu_torch.scene.types import scene_leaves

    leaves = scene_leaves(scene)
    a = leaves[".triangles.a"]
    rng = np.random.default_rng(seed)
    return {".triangles.albedo": torch.ones_like(leaves[".triangles.albedo"]),
            ".triangles.emission": torch.ones_like(leaves[".triangles.emission"]),
            ".triangles.a": torch.from_numpy(rng.standard_normal(
                tuple(a.shape)).astype(np.float32)).to(a.device)}


def jvp_render(scene, cam, tangents, mode: str, **kw):
    """``(image, tangent, traced rays)`` of ``render(..., early_exit=True)``
    along ``tangents`` ({leaf: tensor}) by ``torch.func.jvp`` (``mode="func"``)
    or ``torch.autograd.forward_ad``."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

    leaves = {k: scene_leaves(scene)[k] for k in tangents}

    def fn(lv):
        img, n = render(with_leaves(scene, lv), cam, **kw, early_exit=True)
        return img, torch.tensor(n)  # jvp's aux holds tensors only

    if mode == "func":
        img, dot, n = torch.func.jvp(fn, (leaves,), (tangents,), has_aux=True)
        return img, dot, int(n)
    with fwAD.dual_level():
        img, n = fn({k: fwAD.make_dual(v, tangents[k]) for k, v in leaves.items()})
        img, dot = fwAD.unpack_dual(img)
        return img, dot, int(n)


def check_forward_mode(dev, count) -> dict:
    """Run (x) in this process. ``count(expect, label, fn)`` runs ``fn``
    under the launch counters and returns ``(fn's result, launches)``.
    Returns ``{label: (seconds, launches)}`` and the forward/reverse
    relative difference; raises on a broken identity."""
    import torch

    from raytracingc_tpu_torch.camera import Camera, primary_rays
    from raytracingc_tpu_torch.render.integrator import trace_accumulate
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
    from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    box = scene_from_triangles_txt(BOX_SCENE).to(dev)
    cam = Camera.look_at(device=dev)
    tangents = fwd_tangents(box)
    out = {}

    def timed(label, fn):
        sync()
        t = time.time()
        result, k1 = count("search_brute", f"x {label}", lambda: (fn(), sync())[0],
                           shade=label == "production")
        out[label] = (time.time() - t, k1)
        return result

    with torch.no_grad():
        want, n = timed("production", lambda: render(box, cam, **FWD_RUN))
    for mode in ("func", "forward_ad"):
        img, dot, m = timed(f"jvp {mode}", lambda: jvp_render(box, cam, tangents,
                                                             mode, **FWD_RUN))
        if m != n or not _same_bits(img, want):
            raise AssertionError(f"run x: the {mode} jvp's primal is not the "
                                 f"production render's bits ({m} against {n} rays)")
        if out[f"jvp {mode}"][1] != out["production"][1]:
            raise AssertionError(f"run x: the {mode} jvp launched K1 "
                                 f"{out[f'jvp {mode}'][1]} times, production "
                                 f"{out['production'][1]}")
        if not bool(torch.isfinite(dot).all()) or float(dot.abs().max()) == 0:
            raise AssertionError(f"run x: the {mode} jvp's tangent is not finite "
                                 f"or all zero")

    w_, h_ = FWD_SMALL["width"], FWD_SMALL["height"]
    o, d = primary_rays(cam, w_, h_)
    ids = torch.arange(w_ * h_, device=dev)
    wts = torch.randn((w_ * h_, 3), generator=torch.Generator().manual_seed(FWD_SEED))
    wts = wts.to(dev)
    leaves = {k: scene_leaves(box)[k] for k in tangents}

    def loss(lv, early_exit):
        r, _ = trace_accumulate(o, d, with_leaves(box, lv), ids, seed=0,
                                spp=FWD_SMALL["spp"],
                                max_bounce=FWD_SMALL["max_bounce"],
                                early_exit=early_exit)
        return (r * wts).sum()

    _, fwd = torch.func.jvp(lambda lv: loss(lv, True), (leaves,), (tangents,))
    grad_in = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    loss(grad_in, False).backward()
    rev = sum(float((t.grad * tangents[k]).sum()) for k, t in grad_in.items())
    rel = abs(float(fwd) - rev) / abs(rev)
    if not rel <= FWD_REV_RTOL:
        raise AssertionError(f"run x: jvp {float(fwd)!r} against grad . v {rev!r} "
                             f"(relative {rel:.3g} > {FWD_REV_RTOL})")
    return out, rel


def pose_image(scene, fov, run, **mode):
    """The production (or ``mode``'s) image of ``scene`` as a function of
    ``p``: the camera's origin and view direction (``fit_camera``'s pose),
    then the albedo of triangles :data:`JAC_ROWS`. Returns ``(image,
    traced rays)``."""
    import torch

    from raytracingc_tpu_torch.camera import Camera, look_at_basis
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.types import with_leaves

    rows = torch.tensor(JAC_ROWS, device=scene.device)
    albedo = scene.triangles.albedo

    def image(p):
        x, y, z = p[3:6].unbind(-1)
        ex, ey, ez = look_at_basis(p[:3], p[:3] + p[3:6] / torch.sqrt(x * x + y * y + z * z))
        s = with_leaves(scene, {".triangles.albedo": albedo.index_copy(
            0, rows, p[6:].reshape(-1, 3))})
        return render(s, Camera(origin=p[:3], ex=ex, ey=ey, ez=ez, fov=fov), **run,
                      **mode)
    return image


def check_jacfwd(dev, count) -> dict:
    """Run (x''). ``count`` as :func:`check_forward_mode`'s. Returns
    ``{label: (seconds, K1 launches)}`` and the largest column difference
    of jacfwd against the stacked jvps; raises on a broken identity."""
    import torch

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    box = scene_from_triangles_txt(BOX_SCENE).to(dev)
    cam = Camera.look_at(device=dev)
    p = torch.cat([cam.origin, cam.ez, box.triangles.albedo[list(JAC_ROWS)].reshape(-1)])
    out, worst = {}, 0.0

    def timed(label, fn):
        sync()
        t = time.time()
        result, k1 = count("search_brute", f"x'' {label}", lambda: (fn(), sync())[0],
                           shade=label.startswith("render"))
        out[label] = (time.time() - t, k1)
        return result

    for mode, kw in (("production", dict(early_exit=True)),
                     ("differentiable", dict(early_exit=False))):
        image = pose_image(box, cam.fov, JAC_RUN, **kw)
        with torch.no_grad():
            timed(f"render {mode}", lambda: image(p))
        jac = timed(f"jacfwd {mode}", lambda: torch.func.jacfwd(
            lambda q: image(q)[0])(p))
        if out[f"jacfwd {mode}"][1] != out[f"render {mode}"][1]:
            raise AssertionError(f"run x'': jacfwd {mode} launched K1 "
                                 f"{out[f'jacfwd {mode}'][1]} times, one render "
                                 f"{out[f'render {mode}'][1]}")
        cols = timed(f"{p.numel()} jvps {mode}", lambda: torch.stack(
            [torch.func.jvp(lambda q: image(q)[0], (p,), (e,))[1]
             for e in torch.eye(p.numel(), device=dev)], dim=-1))
        if not bool(torch.isfinite(jac).all()):
            raise AssertionError(f"run x'': jacfwd {mode} is not finite")
        scale = cols.abs().amax(dim=(0, 1, 2))
        diff = (jac - cols).abs().amax(dim=(0, 1, 2))
        rel = float((diff / torch.where(scale > 0, scale, 1.0)).max())
        if rel > JAC_REL or float(scale.max()) == 0:
            raise AssertionError(f"run x'': jacfwd {mode} against the stacked jvps: "
                                 f"{rel:.3g} of a column's largest entry (> {JAC_REL})")
        worst = max(worst, rel)

    image = pose_image(box, cam.fov, JAC_RUN, early_exit=True)
    poses = p[:6] + torch.tensor(JAC_CAMERAS, device=dev)
    rest = p[6:]
    with torch.no_grad():
        imgs, counts = timed("vmap cameras", lambda: torch.func.vmap(
            lambda q: tuple(torch.as_tensor(x) for x in image(torch.cat([q, rest]))))(
                poses))
        one = [timed(f"render camera {k}", lambda: image(torch.cat([poses[k], rest])))
               for k in range(len(JAC_CAMERAS))]
    for k, (img, n) in enumerate(one):
        if not _same_bits(imgs[k], img) or int(counts[k]) != n:
            raise AssertionError(f"run x'': vmap camera {k} is not its render's bits "
                                 f"({int(counts[k])} against {n} rays)")
    # The vmap searches the lanes live in any camera, once per camera a call,
    # for as many bounces as the longest-lived camera needs.
    v, b = out["vmap cameras"][1], len(JAC_CAMERAS)
    if v % b or v < sum(out[f"render camera {k}"][1] for k in range(b)):
        raise AssertionError(f"run x'': the vmap launched K1 {v} times, not once "
                             f"per camera a search")
    return out, worst


def run_dispatch(dev, kernels, totals) -> tuple:
    """Run (y): the dispatch grid through ``calibrate``; each (cell, leg)
    counted on its own. Returns the rows and the crossover."""
    from raytracingc_tpu_torch.tools import dispatch_calibration as dc

    grid = tuple((lv, w, h, spp // DISPATCH_SPP_CUT) for lv, w, h, spp in dc.GRID)
    expect = {"brute": "search_brute", "packet": "search_bitmask"}

    def on_cell(row):
        launched = {k: f.launches for k, f in kernels.items()}
        for k, f in kernels.items():
            totals[k] += f.launches
            f.launches = 0
        want = expect[row["leg"]]
        check_launches(f"run y {row['leg']} level {row['level']}", launched, want,
                       shade=True)
        row["launches"] = launched[want]
        print(f"  {dc.line(row)}, {launched[want]} {want} launches", flush=True)

    for f in kernels.values():
        f.launches = 0
    rows = dc.calibrate(dev, grid, reps=1, on_cell=on_cell)
    return rows, dc.crossover(rows)


def run_granules(dev) -> dict:
    """Run (z). Returns the level-7 chunk's counts and the full frame's
    table (the tool's lines); raises unless card == CPU."""
    import torch

    from raytracingc_tpu_torch.camera import Camera, primary_rays
    from raytracingc_tpu_torch.ops import culling
    from raytracingc_tpu_torch.tools import granule_analysis as ga
    from raytracingc_tpu_torch.tools.union_walk_ab import load_scene

    scene = load_scene(BOX_SCENE, GRANULE_LEVEL, dev)
    tile, _, bpt = ga.layout(scene.accel, culling.STREAM_TILE)
    granules = ga.granules_for(bpt)
    o, d = primary_rays(Camera.look_at(device=dev), 1920, 1080)
    rays = slice(GRANULE_CHUNK, GRANULE_CHUNK + ga.CHUNK)
    t = time.time()
    card = ga.granule_counts(scene.accel, o[rays], d[rays], tile, granules)
    card_s = time.time() - t
    t = time.time()
    cpu = ga.granule_counts(scene.accel.to("cpu"), o[rays].cpu(), d[rays].cpu(),
                            tile, granules)
    cpu_s = time.time() - t
    if card != cpu:
        raise AssertionError(f"run z: the card's counts {card} != the CPU's {cpu}")
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = ga.main(["--device", dev.type, "--tessellate", str(GRANULE_FULL_LEVEL)])
    if rc != 0:
        raise AssertionError(f"run z: granule_analysis exit code {rc}\n{buf.getvalue()}")
    return dict(chunk=card, lines=ga.report(card, bpt), card_s=card_s, cpu_s=cpu_s,
                full=buf.getvalue().splitlines()[1:-1], full_s=time.time() - t)


def run_examples(dev, count, tmp) -> dict:
    """Run (x'): the four examples on ``dev``, each counted (K1 only).
    Returns ``{name: (seconds, loss ratio, error before, error after,
    launches)}``; raises where a JAX test's bar is missed."""
    import importlib

    from raytracingc_tpu_torch.examples import inverse_albedo

    out = {}
    for name, (steps, loss_bar, err_bar) in EXAMPLES.items():
        mod = importlib.import_module(f"raytracingc_tpu_torch.examples.{name}")
        t = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            (losses, e0, e1), k1 = count("search_brute", f"x' {name}",
                                         lambda: mod.main(steps, device=dev))
        ratio = losses[-1] / losses[0]
        out[name] = (time.time() - t, ratio, e0, e1, k1)
        if not (ratio < loss_bar and e1 < err_bar * e0):
            raise AssertionError(f"run x' {name}: loss ratio {ratio:.4g} (bar "
                                 f"{loss_bar}), error {e0:.4g} -> {e1:.4g} (bar "
                                 f"{err_bar}x)\n{buf.getvalue()}")
    t = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, k1 = count("search_brute", "x' inverse_albedo", lambda: inverse_albedo.main(
            ["--device", dev.type, "--out", os.path.join(tmp, "inverse_albedo")]))
    err = re.search(r"loss ([0-9.e-]+) -> ([0-9.e-]+); mean \|albedo err\| "
                    r"([0-9.]+) -> ([0-9.]+)", buf.getvalue())
    if rc != 0 or err is None:
        raise AssertionError(f"run x' inverse_albedo: exit code {rc}\n{buf.getvalue()}")
    l0, l1, e0, e1 = (float(x) for x in err.groups())
    out["inverse_albedo"] = (time.time() - t, l1 / l0, e0, e1, k1)
    return out


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
    from raytracingc_tpu_torch.tools import knobs_set
    from raytracingc_tpu_torch.ops import _build
    from raytracingc_tpu_torch.ops.intersect_mxu import search_mxu, search_mxu_grid
    from raytracingc_tpu_torch.ops.search_bitmask import search_bitmask
    from raytracingc_tpu_torch.ops.search_packed import search_packed
    from raytracingc_tpu_torch.ops.search_range import search_grid as item_grid
    from raytracingc_tpu_torch.ops.search_range import search_range
    from raytracingc_tpu_torch.ops.search_union import search_union
    from raytracingc_tpu_torch.ops.search_words import search_words
    from raytracingc_tpu_torch.render.image import read_bmp
    from raytracingc_tpu_torch.tools import sass_loop, smem_probe, union_walk_ab
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
    smi = tools.card_name()
    if not smi:
        raise SystemExit("chip_smoke: nvidia-smi did not report the card")

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
    reports = {k: _build.ptxas_report(k) for k in (
        "search_brute_kernel", "search_bitmask_kernel", "search_packed_kernel",
        "search_range_kernel",
        "search_words_kernel", "range_items_kernel", "words_items_kernel",
        "unpack_keys_kernel", "search_mxu_kernel", "mxu_pack_kernel",
        "mxu_items_kernel", "shade_kernel", "cull_words_kernel", "compact_kernel")}
    spilled = [k for k in NO_SPILLS if re.search(r"[1-9]\d* bytes spill", reports[k])]
    if spilled:
        raise AssertionError(f"ptxas spills in {spilled}: {reports}")
    packet_ptxas = "; ".join(f"{k}: {v or 'not reported'}" for k, v in reports.items())
    grids = {f"search_{k}_kernel": item_grid(dev, k) for k in ("range", "words")}
    grids.update({f"search_mxu_kernel {prec}": search_mxu_grid(dev, prec)
                  for prec in ("split3", "highest")})
    sass_name, sass_loops = sass_loop.kernel_loops(SASS_KERNEL, _build.library_path())
    if not sass_loops:
        raise AssertionError(f"{sass_name}: no MT loop in its SASS")
    phase("build", t, f"{_build.library_path().name} built in "
          f"{time.time() - t:.2f}s (ptxas: {ptxas or 'cached library'}; "
          f"{packet_ptxas}); persistent grids: " + ", ".join(
              f"{k} {c} CTAs per SM x {n} SMs" for k, (c, n) in grids.items())
          + f"; SASS of {sass_name}'s MT loop (tools/sass_loop.py): " + ", ".join(
              f"{lp['instructions']} instructions issued a pass, {lp['tests']} MT "
              f"test(s): {lp['per_pair']:.1f} a pair (MT_OPS {MT_OPS})"
              for lp in sass_loops))

    # 3. Kernel vs plain, on the card: bitwise.
    t = time.time()
    rng = np.random.default_rng(20261016)
    brute = check_brute_kernel(dev, rng)
    max_abs = brute["max_abs"]
    timed = brute["timed"]
    phase("kernel", t, f"search_brute == search_brute_reference bitwise, both "
          f"entries, on {brute['cases']} cases (n_live {PHASE3_N_LIVE} x R "
          f"{PHASE3_RAYS}, {DEAD:.0%} dead; then " + ", ".join(
              f"{n} x {r} {lanes}" for n, r, lanes in PHASE3_EXTRA)
          + f"); lanes a ray {brute['parts']}; at R={TIMED_RAYS}: " + "; ".join(
              f"{label}: events {v['ms']:.4f} ms (host {v['host']:.4f} ms a call, "
              f"device {v['profiler']:.4f} ms a launch by torch.profiler)"
              + (f", plain {v['plain']:.4f} ms" if "plain" in v else "")
              + (f", bound {v['bound'][0]:.4f} ms ({v['bound'][1]}, "
                 f"{v['pairs']} live pairs; device at {v['bound'][0] / v['profiler']:.1%}), "
                 f"all-pairs bound {v['all_bound'][0]:.4f} ms (device at "
                 f"{v['all_bound'][0] / v['profiler']:.1%})" if "bound" in v else "")
              for label, v in timed.items()))

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
        f"{mxu_bound(label, prec)[0]:.5f} ms ({mxu_bound(label, prec)[1]}), "
        f"{mxu_bound(label, prec)[0] / k:.1%} of bound"
        for label, by_prec in mxu_times.items()
        for prec, (k, p) in by_prec.items()))

    # 3d. The union-walk kernel vs plain and the brute scan.
    t = time.time()
    union_times, union_err, union_work = check_union_kernel(dev, rng)
    union_bound = {label: bound(blocks * RPP * MT_OPS, 0, nbytes)
                   for label, (blocks, nbytes) in union_work.items()}
    phase("kernel", t, "search_union at R=" + str(TIMED_RAYS) + ": " + "; ".join(
        f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f", search_union bound {union_bound[label][0]:.5f} ms "
        f"({union_bound[label][1]}), "
        f"{union_bound[label][0] / ms['search_union']:.1%} of bound"
        for label, ms in union_times.items()))

    # 3e. The shared-memory probe's ladder, and its times.
    t = time.time()
    smem_limit, smem_ms, smem_work, smem_staged, ladder = check_smem_probe(dev)
    l2 = l2_read_rate(dev)
    phase("kernel", t, f"smem_probe: opt-in limit {smem_limit} bytes "
          f"({smem_limit // 4} words); " + ", ".join(
              f"{n}: {'refused (' + str(err.code) + ')' if err else 'OK, == plain'}"
              for n, _, err in ladder) + "; odd sizes == plain; at the limit: "
          + ", ".join(f"{k} {v:.5f} ms" for k, v in smem_ms.items())
          + f"; staging floor {smem_staged} bytes at the L2 read rate of one "
          f"torch.sum over 24 MiB ({l2 / 1e12:.3f} TB/s, an achieved rate, not "
          f"a peak): {smem_staged / l2 * 1e3:.5f} ms")

    # 3f. The shading kernel vs plain, and a frame on each route.
    t = time.time()
    shade_out = check_shade_kernel(dev, rng)
    st = shade_out["timed"]
    phase("kernel", t, f"shade_kernel == its plain versions bitwise, every entry "
          f"(bounce, step, primary, open at group 1 and 2), on {shade_out['cases']} "
          f"cases ({SHADE_LANES} lanes x box_scene with and without its sphere, its "
          f"64-fold tessellation through the permuted resolve table at "
          f"{SHADE_PERM_LANES}; {DEAD:.0%} dead and all alive); 1080p 2 spp 8 "
          f"bounces, kernel route == torch route (albedo requiring grad): "
          f"{shade_out['frame']['rays']} rays both, every pixel's bits, "
          f"{shade_out['frame']['lanes']} kernel lanes in "
          f"{shade_out['frame']['launches']} launches, mean "
          f"{shade_out['frame']['mean']:.5f}; host us a call: route "
          f"{shade_out['host']['route']:.2f}, table pointers "
          f"{shade_out['host']['tables']:.2f} built, "
          f"{shade_out['host']['tables reused']:.2f} reused; "
          f"bounce at {SHADE_TIMED} lanes: events {st['ms']:.4f} ms (host "
          f"{st['host']:.4f} ms a call, device {st['profiler']:.4f} ms a launch by "
          f"torch.profiler), plain {st['plain']:.4f} ms, bound {st['bound'][0]:.5f} ms "
          f"({st['bound'][1]}, {st['bytes']} bytes; device at "
          f"{st['bound'][0] / st['profiler']:.1%}); ptxas: {shade_out['report']}")

    # 3g. The culling prelude's kernel vs its plain version.
    t = time.time()
    cull = check_cull_kernel(dev, np.random.default_rng(CULL_SEED))
    phase("kernel", t, f"cull_words == its plain version (the entry on a CPU copy) "
          f"bitwise through every word route's entry on {cull['cases']} cases "
          f"(R {CULL_RAYS}; coherent "
          f"and secondary-like, {DEAD:.0%} dead, alive=None, special values): "
          + "; ".join(cull["notes"]) + f"; {CULL_TIMED}: " + "; ".join(
              f"{tag}: events {v['ms']:.4f} ms (host {v['host']:.4f} ms a call, "
              f"device {v['profiler']:.4f} ms a launch by torch.profiler), "
              f"cull_words_reference {v['plain']:.4f} ms (host {v['plain host']:.4f} "
              f"ms a call), "
              f"bound {v['bound'][0]:.5f} ms ({v['bound'][1]}, {v['live']} live "
              f"rays; device at {v['bound'][0] / v['profiler']:.1%}), "
              f"{v['nonzero']} nonzero words"
              for tag, v in cull["timed"].items()))

    # 3h. The compaction kernel vs torch.nonzero and the gathers, and a
    # frame of each benchmark scene on each route.
    t = time.time()
    comp = check_compact_kernel(dev, np.random.default_rng(COMPACT_SEED))
    ct = comp["timed"]
    phase("kernel", t, f"compact_kernel == torch.nonzero and the gathers (its plain "
          f"version) bitwise on {comp['cases']} cases ({COMPACT_LANES} lanes x "
          f"{COMPACT_DENSITIES} live; a bounce's with ids and the write-back, the "
          f"entry's without); {comp['burst']['launches']} launches back to back over "
          f"{comp['burst']['lanes']} lanes, each == torch.nonzero; " + "; ".join(
              f"{name} 1080p 2 spp 8 bounces: kernel route == compaction forced to "
              f"torch, {fr['rays']} rays, every pixel's bits, mean {fr['mean']:.5f}, "
              f"{fr['launches']} compact_kernel launches over {fr['lanes']} lanes, "
              f"wall {fr['wall']:.3f}s [torch route {fr['torch_wall']:.3f}s]"
              for name, fr in comp["frames"].items())
          + f"; a bounce at {COMPACT_TIMED} lanes ({ct['live']} live): events "
          f"{ct['ms']:.4f} ms (host {ct['host']:.4f} ms a call, device "
          f"{ct['profiler']:.4f} ms a launch by torch.profiler), the torch "
          f"compaction {ct['plain']:.4f} ms (host {ct['plain host']:.4f} ms a call), "
          f"bound {ct['bound'][0]:.5f} ms ({ct['bound'][1]}, {ct['bytes']} bytes; "
          f"device at {ct['bound'][0] / ct['profiler']:.1%}); ptxas: {comp['report']}")

    # 4. Main path: the CLI in default mode and under the knobs that pick a
    # kernel, then the two tools, on the card. Every kernel's count is set
    # to 0 just before each run and read just after it. Every search of a
    # word route (bitmask, packed, words, mxu) computes its words with one
    # launch of the culling kernel, and no other search does.
    from raytracingc_tpu_torch.ops import culling
    from raytracingc_tpu_torch.utils.profiling import COUNTS

    kernels = kernel_counters()
    total_launches = dict.fromkeys(kernels, 0)
    total_launches["cull_words"] = 0
    word_routes = ("search_bitmask", "search_packed", "search_words", "search_mxu")
    traced, means = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra, shape, expect, env, twin, exact in MAIN_RUNS:
            t = time.time()
            out = os.path.join(tmp, f"main_{label[0]}.bmp")
            for fn in kernels.values():
                fn.launches = 0
            culling.cull_words.launches = 0
            packets0 = COUNTS["search.cull_packets"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), knobs_set(env):
                rc = cli_main(["--device", "cuda", "--triangles", BOX_SCENE,
                               "-o", out, "--profile", *extra])
            log = buf.getvalue()
            launched = {k: fn.launches for k, fn in kernels.items()}
            for k, v in launched.items():
                total_launches[k] += v
            packets = COUNTS["search.cull_packets"] - packets0
            cull_launches = culling.cull_words.launches
            total_launches["cull_words"] += cull_launches
            # The range route's spans are torch slab tests; brute culls nothing.
            want = launched[expect] if expect in word_routes else 0
            if cull_launches != want or (expect in word_routes and packets == 0):
                raise AssertionError(
                    f"{label}: {cull_launches} cull_words launches, expected "
                    f"{want} (search.cull_packets {packets})")
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
            check_launches(label, launched, expect, shade=True)
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
                  f"launches, {launched['shade_kernel']} shade_kernel launches, "
                  f"{cull_launches} cull_words launches ({packets} packets), mean "
                  f"byte {mean:.2f}, BMP sha256 {digest}{same}")

        # Runs (r)-(u): progressive rendering and its resume, the heatmap,
        # the trace and the loader entry point.
        count = lambda expect, label, fn, shade=True: counted(
            kernels, total_launches, expect, label, fn, shade)
        t = time.time()
        prog = check_progressive(dev, tmp, cli_main, count,
                                 os.path.join(tmp, "main_b.bmp"), traced["b"])
        r, r2, api = prog["r"], prog["r'"], prog["api"]
        phase("main", t, f"r: {' '.join(PROGRESSIVE_FLAGS)} --checkpoint F "
              f"--batch-spp {PROGRESSIVE_BATCH}: render {r['wall']:.3f}s, "
              f"{r['rays']} rays (== (b)'s), {r['launches']} search_brute "
              f"launches, checkpoint writes {sum(r['saves']):.3f}s in "
              f"{len(r['saves'])} ({sum(r['saves']) / r['wall']:.1%} of the render; "
              f"each " + ", ".join(f"{x:.3f}" for x in r["saves"]) + " s), "
              f"{r['bytes_differ']:.4%} of BMP bytes differ from (b)'s by 1; API "
              f"render {api['one']:.3f}s, render_progressive {api['prog']:.3f}s, "
              f"within {REASSOC_PROGRESSIVE} (max rel {api['max_rel']:.3g}), same "
              f"rays, its checkpoint == (r)'s bit for bit")
        phase("main", t, f"r': stopped after {PROGRESSIVE_STOP} samples, resumed "
              f"through the CLI: render {r2['wall']:.3f}s, {r2['launches']} "
              f"search_brute launches; BMP byte-identical to (r)'s, linear image "
              f"== the uninterrupted API run's bits")
        t = time.time()
        dbg = check_debug(dev, tmp, cli_main, count)
        phase("main", t, f"s: --debug-bounces {' '.join(DEBUG_FLAGS)}: render "
              f"{dbg['wall']:.3f}s (API {dbg['api']:.3f}s), {dbg['launches']} "
              f"search_bitmask launches, mean bounces {dbg['mean_bounces']:.3f}; "
              f"multiples of 1/{DEBUG['max_bounce']} only, the API's bytes == the CLI's; "
              f"{DEBUG_SMALL}: card == CPU on {dbg['same']:.4f} of pixels")
        t = time.time()
        tr = check_trace(tmp, cli_main, count)
        phase("main", t, f"t: --trace on {' '.join(TRACE_FLAGS)}: render "
              f"{tr['wall']:.3f}s, {tr['rays']} rays; trace {tr['size']} bytes, "
              f"{tr['kernels']} device kernel events ({tr['device_us'] / 1e3:.3f} "
              f"ms), {tr['launches']} search_brute events == launches "
              f"({tr['brute_us'] / 1e3:.3f} ms)")
        t = time.time()
        ot = check_objtest(tmp)
        phase("main", t, f"u: objtest --native ({ot['library']}, built and run "
              f"in {ot['seconds']:.2f}s): " + " | ".join(ot["logs"])
              + "; native arrays == the Python parser's")

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

    # 6. The integrator's other modes, at 1080p on run (b)'s scene.
    t = time.time()
    modes = check_modes(dev)
    phase("modes", t, f"{MODES_RUN}: differentiable, sample_group 2 and auto == "
          f"production bitwise, oracle and sample_batch 2 / 4 / auto (production "
          f"and differentiable; auto also at --tessellate {SB_K2_TESSELLATE}, K2) "
          f"within {REASSOC}, counts equal; " + ", ".join(
              f"{k} {s:.3f}s ({n} rays, {k1} "
              f"{'search_bitmask' if 'triangles' in k else 'search_brute'} launches)"
              for k, (s, n, k1) in modes.items()))
    t = time.time()
    sb = time_sample_batch(dev)
    phase("modes", t, f"{smi}; {SB_RUN}, box_scene, {SB_ROUNDS} alternating "
          f"rounds: sample_batch 8 within {REASSOC} of 1, auto == 8 and "
          f"sample_group auto == 1 bitwise, counts equal; " + "; ".join(
              f"{k}: median {np.median(w):.3f}s (min {min(w):.3f}, max {max(w):.3f}), "
              f"{k1} search_brute launches/frame, {n / np.median(w):.4e} rays/s"
              for k, (w, n, k1) in sb.items()))

    # Run (q): the training path, counted like the main runs.
    t = time.time()
    for fn in kernels.values():
        fn.launches = 0
    train, t_fwd, t_bwd = run_training(dev)
    launched = {k: fn.launches for k, fn in kernels.items()}
    for k, v in launched.items():
        total_launches[k] += v
    # The target and the production twin render with no derivative; each
    # fit's steps launched no shading kernel (run_training checks).
    check_launches("run q", launched, "search_bitmask", shade=True)
    phase("main", t, f"q: training, box_scene --tessellate {TRAIN_TESSELLATE}, "
          f"{TRAIN}: one albedo step forward {t_fwd:.3f}s (production's bits), "
          f"backward {t_bwd:.3f}s, backward/forward {t_bwd / t_fwd:.2f}; " + "; ".join(
              f"{k}: {len(ls)} steps, {sec / len(ls):.3f} s/step, {k2 / len(ls):g} "
              f"search_bitmask launches/step, loss {ls[0]:.6g} -> {ls[-1]:.6g}"
              for k, (ls, sec, k2) in train.items())
          + f"; {launched['search_bitmask']} search_bitmask launches in all")

    t = time.time()
    sc = train_scene(dev)
    g_gpu, n_gpu = scene_grads(sc, cam, GRAD_RUN)
    g_cpu, n_cpu = scene_grads(sc.to("cpu"), cam.to("cpu"), GRAD_RUN)
    rel = {k: float((g_gpu[k] - g_cpu[k]).norm() / g_cpu[k].norm())
           for k in g_cpu if float(g_cpu[k].norm()) > 0}
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_REL or not all(torch.isfinite(g).all() for g in g_gpu.values()):
        raise AssertionError(f"gradients cuda vs cpu: {rel}")
    from raytracingc_tpu_torch.diff import pixel_grad_check

    fd = pixel_grad_check(untie_albedo(sc), cam, **FD_RUN)
    if fd["pass_rate"] < FD_BAR:
        raise AssertionError(f"FD pass rate {fd['pass_rate']} < {FD_BAR}: " + str(
            {k: (v["pass"], v["total"]) for k, v in fd.items() if k != "pass_rate"}))
    phase("train", t, f"gradients at {GRAD_RUN}: cuda vs cpu ({n_gpu} / {n_cpu} "
          f"rays) on {len(rel)} nonzero leaves, worst relative L2 {rel[worst]:.3g} "
          f"({worst}); FD pass rate {fd['pass_rate']:.4f} on box_scene "
          f"--tessellate {TRAIN_TESSELLATE} untied, {FD_RUN}: " + ", ".join(
              f"{k} {v['pass']}/{v['total']}" for k, v in fd.items() if k != "pass_rate"))

    # 7. The multi-rank layer: run (v) in this process, a world of one rank
    # over NCCL; run (w) in PARALLEL_RANKS child processes on this card over
    # gloo. Each is counted like the main runs: K1 (box_scene) and K2 (the
    # tessellated scenes and the training step), in this process and, for
    # (w), in the children (each prints its counts).
    import torch.distributed as dist

    def parallel_launches(label, launched):
        for k, v in launched.items():
            total_launches[k] += v
        check_launches(f"run {label}", launched, ("search_brute", "search_bitmask"),
                       shade=True)
        return launched

    t = time.time()
    for fn in kernels.values():
        fn.launches = 0
    one_rank = run_parallel_one_rank(dev)
    launched = parallel_launches("v", {k: fn.launches for k, fn in kernels.items()})
    phase("parallel", t, f"v: a world of one rank ({dist.get_backend()}) on "
          f"{smi}, {PARALLEL}: render_sharded pixels / samples / both == render "
          f"bitwise (K1), blocks at --tessellate {PARALLEL_TESSELLATE} == "
          f"replicated bitwise (K2), the one-rank mesh's train step at {TRAIN} == "
          f"fit_scene's step bitwise; " + ", ".join(
              f"{k} {sec:.3f}s ({v:.6g} {'loss' if 'train' in k else 'rays'})"
              for k, (sec, v) in one_rank.items())
          + f"; launches {({k: v for k, v in launched.items() if v})}")
    dist.destroy_process_group()

    # Each child's own runs launched their kernels: K1 in the CLI's and the
    # samples render (box_scene), K2 in the block-sharded render and the
    # train step (this process's replicated twins count apart).
    t = time.time()
    for fn in kernels.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_parallel_ranks(dev, tmp, cli_main)
    launched = {k: fn.launches for k, fn in kernels.items()}
    for r in ranks["ranks"]:
        # The block-sharded render resolves in torch and steps on the
        # shading kernel; the jvp and the train step take the torch route.
        for label, want, shaded in (
                ("cli", "search_brute", True), ("samples", "search_brute", True),
                ("jvp samples", "search_brute", False),
                ("blocks", "search_bitmask", True),
                ("train target", "search_bitmask", True),
                ("train", "search_bitmask", False)):
            check_launches(f"run w, rank {r['rank']}, its {label} run",
                           r["launches"][label], want, shaded)
        for per_run in r["launches"].values():
            for k, v in per_run.items():
                launched[k] += v
    parallel_launches("w", launched)
    worst, rel, loss_rel, n_leaves = ranks["train"]
    phase("parallel", t, f"w: {PARALLEL_RANKS} ranks over gloo on {smi}, "
          f"{PARALLEL}: --shard pixels BMP == one device's, same rays; blocks at "
          f"--tessellate {PARALLEL_TESSELLATE} == replicated bitwise; samples == "
          f"mean of the offset renders bitwise; the 2x1 train step's gradients "
          f"within {PARALLEL_GRAD_REL} of one device's ({n_leaves} leaves, worst "
          f"relative L2 {rel:.3g} on {worst}, loss {loss_rel:.3g}); " + "; ".join(
              f"rank {r['rank']}: " + ", ".join(
                  f"{k} {v[0]:.3f}s ({v[1]:.6g})" for k, v in r.items()
                  if isinstance(v, list)) for r in ranks["ranks"])
          + "; this process: " + ", ".join(
              f"{k} {sec:.3f}s ({n} rays)" for k, v in ranks.items()
              if k not in ("ranks", "train") for sec, n in (v,))
          + f"; launches {({k: v for k, v in launched.items() if v})}")

    # 8. The last entry points: forward mode (run (x); its sample-sharded
    # half ran in (w)), the dispatch grid (y), the granule counts (z) and
    # the four examples (x'), each counted like the main runs.
    count = lambda expect, label, fn, shade=True: counted(
        kernels, total_launches, expect, label, fn, shade)
    t = time.time()
    fwd, fwd_rel = check_forward_mode(dev, count)
    w_jvp = [r["jvp samples"] for r in ranks["ranks"]]
    phase("forward", t, f"x: {FWD_RUN}, box_scene, tangents on .triangles.albedo, "
          f".emission, .a: torch.func.jvp and forward_ad primals == production "
          f"bitwise, K1 launches == production's; " + ", ".join(
              f"{k} {sec:.3f}s ({k1} search_brute launches)"
              for k, (sec, k1) in fwd.items())
          + f"; {FWD_SMALL}: jvp vs grad . v relative {fwd_rel:.3g} (<= "
          f"{FWD_REV_RTOL}); in run (w) {PARALLEL_RANKS} gloo ranks' "
          f"sample-sharded jvp == the mean of the offset one-device jvps "
          f"bitwise (" + ", ".join(f"rank {i} {sec:.3f}s" for i, (sec, _)
                                   in enumerate(w_jvp)) + ")")

    t = time.time()
    jac, jac_rel = check_jacfwd(dev, count)
    phase("forward", t, f"x'': {JAC_RUN}, box_scene, torch.func.jacfwd by the "
          f"pose and the albedo of triangles {JAC_ROWS}: == the stacked "
          f"torch.func.jvp's within {jac_rel:.3g} of a column's largest entry (<= "
          f"{JAC_REL}), K1 launches == one render's; torch.func.vmap over "
          f"{len(JAC_CAMERAS)} cameras == the renders bitwise; " + ", ".join(
              f"{k} {sec:.3f}s ({k1} search_brute launches)"
              for k, (sec, k1) in jac.items()))

    t = time.time()
    print(f"[dispatch] {smi}", flush=True)
    rows, cross = run_dispatch(dev, kernels, total_launches)
    phase("dispatch", t, f"y: dispatch_calibration grid (spp cut "
          f"{DISPATCH_SPP_CUT}-fold): brute and packet legs equal in "
          f"BMP bytes and traced rays in all {len(rows) // 2} cells, brute "
          f"launched only K1, packet only K2; " + "; ".join(
              f"{r['leg']} {r['n_live']} {r['width']}x{r['height']} {r['spp']} spp "
              f"{r['rays_per_s']:.4e} rays/s" for r in rows)
          + "; crossover " + json.dumps(cross))

    t = time.time()
    gran = run_granules(dev)
    phase("granule", t, f"z: level {GRANULE_LEVEL}, the 65,536 rays from pixel "
          f"{GRANULE_CHUNK}: card == CPU ({gran['card_s']:.3f}s / "
          f"{gran['cpu_s']:.3f}s): " + "; ".join(gran["lines"])
          + f" | level {GRANULE_FULL_LEVEL}, 1920x1080 ({gran['full_s']:.2f}s): "
          + "; ".join(gran["full"]))

    t = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        examples = run_examples(dev, count, tmp)
    phase("examples", t, "x': " + "; ".join(
        f"{name}: {sec:.2f}s, loss ratio {ratio:.4g}, error {e0:.4g} -> {e1:.4g}, "
        f"{k1} search_brute launches"
        for name, (sec, ratio, e0, e1, k1) in examples.items()))

    # The kernel line's times are those at the main path's shapes: R =
    # TIMED_RAYS with box_scene at 640 (brute; mxu, split3, as in run (k)),
    # 10,240 (bitmask; union, the union tool's scene) and 163,840 (packed,
    # range and words streamed) triangles, and the probe at the device's
    # limit; the [kernel] lines have the others. Each bound counts the work
    # these inputs need: every (ray, triangle) pair the kernel's culling
    # table makes it test (live rays x n_live for brute).
    src = "raytracingc_tpu_torch/csrc/{}.cu"
    sources = {"search_union": src.format("search_words"),
               "shade_kernel": src.format("shade"),
               "compact_kernel": src.format("compact")}
    tpu = "raytracingc_tpu/ops/intersect_pallas.py:{}"
    packet_row = lambda label: (packet_times[label], packet_bound[label])
    k1 = timed[BRUTE_TIMED]
    rows = [
        ("search_brute", tpu.format(1278), (k1["ms"], k1["plain"]), k1["bound"], max_abs),
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
        ("smem_probe", "tools/smem_probe.py:20", (smem_ms["ms"], smem_ms["plain"]),
         bound(smem_work[0], 0, smem_work[1]), 0.0),
        ("shade_kernel", "none (XLA's fusions of the integrator's per-lane ops)",
         (st["ms"], st["plain"]), st["bound"], 0.0),
        ("cull_words", "none (the XLA-side prelude, " + tpu.format(1692)
         + " _slab_any_hit and its callers)",
         (cull["timed"][f"primary R={CULL_TIMED_RAYS[0]}"]["ms"],
          cull["timed"][f"primary R={CULL_TIMED_RAYS[0]}"]["plain"]),
         cull["timed"][f"primary R={CULL_TIMED_RAYS[0]}"]["bound"], 0.0),
        ("compact_kernel", "none (XLA ran fixed widths; torch.nonzero and the "
         "gathers of render/integrator.py)", (ct["ms"], ct["plain"]), ct["bound"], 0.0),
    ]
    phase("total", t0, "chip_smoke.py up to the kernel line")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": sources.get(name, src.format(name)),
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
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), json.loads(sys.argv[3])))
    sys.exit(main())
