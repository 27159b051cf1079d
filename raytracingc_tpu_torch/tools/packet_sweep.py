"""Search-kernel timing (K1-K9): the brute, bitmask, packed, range, words,
MXU and union-walk wrappers over the timed scenes and their ray sets.

Times the bitmask (K2), packed (K3), range (K4, K5) and words (K6, K7)
wrappers by CUDA events on chip_smoke.py's timed packet scenes (box_scene
tessellated to 10,240, 40,960 and 163,840 triangles: bitmask, packed
resident, packed streamed; 40,960 and 163,840 under ``RTC_CULL=range``:
range resident and streamed, and under ``RTC_STREAM_CULL=words``: words
resident K6 and streamed K7) at ``--rays`` rays, on the coherent and the
secondary-like packets of ``tools/packets.py``, and the range and words
scenes also on packets of which some span the whole plane
(``wide_span_rays``). Each wrapper must equal its plain version bit for
bit. On the words scenes it also times K3's kernel on the same words (one
word per tile): one warp per packet walking the packet's whole list, with
no work items, the yardstick of the words kernel's split.

The program-union kernels run on their program union words
(``culling.program_union_words``): the MXU kernel K8 (``RTC_KERNEL=mxu``)
in both precisions on box_scene tessellated to 640 and 2,560 triangles and
on an 8,192-triangle soup (``tools/packets.py::soup_scene``), held to its
plain version's winners on 99% of live lanes (chip_smoke.py phase 3c holds
its contract) and printed with a digest of its result, so that two builds
can be compared bit for bit; the union walk K9 at 10,240 triangles, bit
for bit.

The brute search K1 runs at box_scene tessellated to 640 triangles (and
to 10,240 under ``RTC_KERNEL=brute``: the kernel's tiled walk), at
``--rays`` rays and a quarter of that (a compacted bounce), on both ray
sets with their dead lanes and with every lane live (``alive=None``), from
its own generator: through ``search_brute`` on packed rows and through the
brute leg of ``search.search_triangles`` (no grad, as in the production
render), each bit for bit equal to the plain scan, each timed by
``tools.split_times`` (events with the host, the host per call and the
device time of a launch by torch.profiler).

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
import functools
import hashlib
import sys
import types

import numpy as np
import torch

from raytracingc_tpu_torch.ops import _build, culling, search
from raytracingc_tpu_torch.ops.accel import BLOCK, build_accel
from raytracingc_tpu_torch.ops.intersect_mxu import search_mxu, search_mxu_reference
from raytracingc_tpu_torch.ops.search_bitmask import (
    bitmask_table,
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
from raytracingc_tpu_torch.ops.search_union import search_union, search_union_reference
from raytracingc_tpu_torch.ops.search_words import (
    search_words,
    search_words_reference,
)
from raytracingc_tpu_torch.tools import BOX_SCENE, cuda_ms, knobs_set, split_times
from raytracingc_tpu_torch.tools.packets import (
    DEAD,
    RAY_SETS,
    SOUP_ORIGINS,
    packet_inputs,
    soup_scene,
    wide_span_rays,
)
from raytracingc_tpu_torch.tools.union_walk_ab import load_scene

# (label, box_scene tessellation levels or a soup's triangle count, knobs)
# of chip_smoke.py's timed K2-K9 cases.
RANGE = {"RTC_CULL": "range"}
WORDS = {"RTC_STREAM_CULL": "words"}
MXU = {"RTC_KERNEL": "mxu"}
BRUTE = {"RTC_KERNEL": "brute"}
SCENES = (("K1 box 640 (brute)", 3, {}),
          ("K1 box 10,240 tiled (RTC_KERNEL=brute)", 5, BRUTE),
          ("K2 box 10,240", 5, {}), ("K3 box 40,960 resident", 6, {}),
          ("K3 box 163,840 streamed", 7, {}),
          ("K4 box 40,960 (RTC_CULL=range)", 6, RANGE),
          ("K5 box 163,840 streamed (RTC_CULL=range)", 7, RANGE),
          ("K6 box 40,960 resident (RTC_STREAM_CULL=words)", 6, WORDS),
          ("K7 box 163,840 streamed (RTC_STREAM_CULL=words)", 7, WORDS),
          ("K8 box 640 (RTC_KERNEL=mxu)", 3, MXU),
          ("K8 box 2,560 (RTC_KERNEL=mxu)", 4, MXU),
          ("K8 soup 8,192 (RTC_KERNEL=mxu)", "soup 8192", MXU),
          ("K9 box 10,240 union walk", 5, {}))
MXU_AGREE = 0.99  # share of live lanes whose K8 winner is the plain version's
BOX_ORIGINS = ((-5.0, -5.0, -5.0), (5.0, 1.5, 5.0))  # inside box_scene's room


def words_inputs(scene, o, d, alive):
    """``(route, words, plane, orig_idx)`` of the dispatch's words route."""
    accel = scene.accel
    way = search.route(scene.n_triangles, accel.n_blocks, search.Knobs.read())
    words = culling.packet_tile_words(o, d, alive, accel, way.n_tiles,
                                      way.tile // BLOCK, way.granule)
    plane, oi = culling.stream_tile_pad(accel.packed_plane, accel.orig_idx, way.tile)
    return way, words, plane, oi


def packet_walk_call(scene, o, d, alive):
    """K3's kernel (``search_packed``) on the words route's inputs, one word
    per tile: the same blocks walked by one warp per packet, unsplit."""
    way, words, plane, oi = words_inputs(scene, o, d, alive)
    words = words[..., None].contiguous()
    return lambda: search_packed(o, d, words, plane, oi, way.tile, way.granule)


def case_calls(scene, o, d, alive):
    """``(route, wrapper call, plain call, tested pairs)`` of the dispatch's
    packet, range or words route for these rays on ``scene``."""
    accel = scene.accel
    way = search.route(scene.n_triangles, accel.n_blocks, search.Knobs.read())
    if way.kernel == "words":
        way, words, plane, oi = words_inputs(scene, o, d, alive)
        args = (o, d, words, plane, oi, way.tile, way.granule)
        table = packed_table(words[..., None], way.tile // BLOCK, way.granule)
        return (way, lambda: search_words(*args),
                lambda: search_words_reference(*args),
                int(table.sum()) * culling.RAY_SUBLANES * BLOCK)
    if way.kernel == "range":
        first, last = culling.packet_block_ranges(o, d, alive, accel)
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


def program_calls(scene, o, d, alive, union: bool):
    """``({name: (kernel call, plain call)}, tested pairs)`` of the
    program-union kernels on these rays' program words: K9 (``union``) or
    K8 in both precisions."""
    accel = scene.accel
    words, flags = culling.program_union_words(o, d, alive, accel)
    pairs = (int(bitmask_table(words, accel.n_blocks).sum())
             * culling.RAYS_PER_PROGRAM * BLOCK)
    if union:
        args = (o, d, words, flags, accel.packed_plane, accel.orig_idx)
        return {"K9 union": (functools.partial(search_union, *args),
                             functools.partial(search_union_reference, *args))}, pairs
    calls = {}
    for prec in ("split3", "highest"):
        args = (o, d, words, flags, accel.mxu_coeffs, accel.orig_idx, prec, alive)
        calls[f"K8 {prec}"] = (functools.partial(search_mxu, *args),
                               functools.partial(search_mxu_reference, *args))
    return calls, pairs


def digest(dst, idx) -> str:
    """A short hash of a search result's bits."""
    h = hashlib.sha256(dst.cpu().numpy().tobytes())
    h.update(idx.cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def load(levels, dev, rng):
    """box_scene tessellated ``levels`` times, or ``"soup N"``: an N-triangle
    soup, with its accel."""
    if isinstance(levels, int):
        return load_scene(BOX_SCENE, levels, dev)
    tris, n = soup_scene(rng, int(levels.split()[1]))
    tris = tris.to(dev)
    return types.SimpleNamespace(triangles=tris, n_triangles=n,
                                 accel=build_accel(tris, n))


def time_programs(label, scene, set_name, o, d, alive, iters):
    """The program-union kernels of one case: each call against its plain
    version, then timed."""
    union = label.startswith("K9")
    calls, pairs = program_calls(scene, o, d, alive, union)
    for name, (kernel, plain) in calls.items():
        (kd, ki), (pd, pi) = kernel(), plain()
        if union:
            ok = torch.equal(ki, pi) and torch.equal(kd.view(torch.int32),
                                                     pd.view(torch.int32))
        else:
            ok = float((ki == pi)[alive].float().mean()) >= MXU_AGREE
        if not ok:
            raise AssertionError(f"{label} {set_name} {name}: the wrapper differs "
                                 f"from the plain version")
        print(f"[wrappers] {label} {set_name} ({name}; {pairs} tested pairs): "
              f"wrapper {cuda_ms(kernel, iters):.4f} ms, result digest "
              f"{digest(kd, ki)}", flush=True)


def time_brute(label, scene, rng, n_rays, dev, origins, knobs=None):
    """K1 at ``n_rays`` and a quarter of that: both ray sets, with their
    dead lanes and all lanes live; the packed entry and the dispatch's
    brute leg (under ``knobs``), each against the plain scan bit for bit,
    then timed."""
    tris, n = scene.triangles, scene.n_triangles
    tri = pack_triangles(tris, n)
    for r in (n_rays, n_rays // 4):
        for set_name, make in RAY_SETS.items():
            o, d, alive = (torch.from_numpy(x).to(dev) for x in make(rng, r, *origins))
            for lanes, al in ((f"{DEAD:.0%} dead", alive), ("all live", None)):
                want_d, want_i = search_brute_reference(o, d, tri, n, al)
                calls = {
                    "packed": lambda: search_brute(o, d, tri, n, al),
                    "dispatch leg": lambda: search.search_triangles(
                        o, d, tris, n, alive=al, accel=scene.accel),
                }
                for name, call in calls.items():
                    with torch.no_grad(), knobs_set(knobs or {}):
                        got_d, got_i = call()
                        if not (torch.equal(got_i, want_i) and torch.equal(
                                got_d.view(torch.int32), want_d.view(torch.int32))):
                            raise AssertionError(f"{label} {set_name} R={r} {lanes} "
                                                 f"{name}: differs from the plain scan")
                        v = split_times(call, "search_brute")
                    pairs = (r if al is None else int(al.sum())) * n
                    print(f"[wrappers] {label} {set_name} R={r} {lanes} ({name}; "
                          f"{pairs} live pairs): events {v['ms']:.4f} ms, host "
                          f"{v['host']:.4f} ms a call, device {v['profiler']:.4f} ms "
                          f"a launch", flush=True)
    print(f"[ptxas] search_brute_kernel: "
          f"{_build.ptxas_report('search_brute_kernel') or 'cached library'}", flush=True)


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
        scene = load(levels, dev, rng)
        origins = BOX_ORIGINS if isinstance(levels, int) else SOUP_ORIGINS
        if label.startswith("K1"):
            time_brute(label, scene, np.random.default_rng([args.seed, 1]), args.rays,
                       dev, origins, knobs)
            continue
        ray_sets = dict(RAY_SETS)
        if knobs in (RANGE, WORDS):
            ray_sets["whole-plane"] = lambda *a: wide_span_rays(*a, scene.accel)
        for set_name, make in ray_sets.items():
            o, d, alive = (torch.from_numpy(x).to(dev)
                           for x in make(rng, args.rays, *origins))
            if knobs == MXU or label.startswith("K9"):
                time_programs(label, scene, set_name, o, d, alive, args.iters)
                continue
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
            if way.kernel == "words":
                with knobs_set(knobs):
                    unsplit = packet_walk_call(scene, o, d, alive)
                pk_d, pk_i = unsplit()
                if not (torch.equal(pk_i, ref_i) and torch.equal(
                        pk_d.view(torch.int32), ref_d.view(torch.int32))):
                    raise AssertionError(f"{label} {set_name}: K3's kernel on the "
                                         f"words differs from the plain version")
                print(f"[wrappers] {label} {set_name}: K3's kernel on these words "
                      f"(one warp per packet, unsplit) {cuda_ms(unsplit, args.iters):.4f} ms",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
