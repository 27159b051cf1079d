"""Union-walk A/B (K9): program-level union culling against the production search.

Counterpart of ``tools/union_walk_ab.py``. Per 1,024-ray program the union
walk ORs the 128 packets' block words and runs the brute kernel's scalar
Möller–Trumbore over every set block for every ray of the program
(``ops/search_union.py``); the production search culls per 8-ray packet.
The three workloads are the JAX tool's: the leading slice of a frame's
primary rays, a slice from its centre, and the compacted secondary front
(the frame's primary hits packed to the front, seeded random directions).
The scene is ``examples/box_scene.txt`` tessellated (10,240 triangles by
default; the JAX tool's ``suzannes.obj`` is not in the repository).

For each workload it prints whether the union walk equals the production
search bit for bit on live lanes, the (ray, triangle) pairs each tests, and
the kernel times by CUDA events ("not measured" on the CPU, and with
``--iters 0``, where the union walk runs once per workload, for its check).
Where the scene fits the MXU kernel (at most 8,192 padded triangles), K8 is
timed on the same union words too: tensor-core planes against CUDA-core MT
per tested pair.

    python -m raytracingc_tpu_torch.tools.union_walk_ab [--device cuda|cpu]
        [--tessellate 5] [-s 1920 1080] [--rays 262144] [--iters 20]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops.accel import BLOCK
from raytracingc_tpu_torch.ops.intersect_mxu import search_mxu
from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table, search_bitmask
from raytracingc_tpu_torch.ops.search_union import search_union
from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt, tessellate
from raytracingc_tpu_torch.scene.types import MISS_DST
from raytracingc_tpu_torch.tools import BOX_SCENE, cuda_ms


def load_scene(path: str, levels: int, device):
    """box_scene (or another triangles.txt) tessellated, with its accel."""
    scene = scene_from_triangles_txt(path)
    if levels > 0:
        tris, n = tessellate(scene.triangles, scene.n_triangles, levels=levels)
        scene = dataclasses.replace(scene, triangles=tris, n_triangles=n,
                                    accel=None).with_accel()
    return scene.to(device)


def masked(alive, dst, idx):
    return (torch.where(alive, dst, MISS_DST), torch.where(alive, idx, -1))


def production(scene, o, d, alive):
    """The default dispatch, dead lanes masked."""
    dst, idx = search.search_triangles(o, d, scene.triangles, scene.n_triangles,
                                       alive=alive, accel=scene.accel)
    return masked(alive, dst, idx)


@dataclasses.dataclass
class Tables:
    """The culling words of one batch: per packet (K2) and per program (K8,
    K9), and the (ray, triangle) pairs each makes a kernel test."""

    packet_words: torch.Tensor
    words: torch.Tensor
    flags: torch.Tensor
    packet_pairs: int
    union_pairs: int


def tables(scene, o, d, alive) -> Tables:
    accel = scene.accel
    packet_words = culling.packet_block_masks(o, d, alive, accel)
    words, flags = culling.program_union(packet_words)
    n_blocks = accel.n_blocks
    return Tables(
        packet_words, words, flags,
        int(bitmask_table(packet_words, n_blocks).sum()) * culling.RAY_SUBLANES * BLOCK,
        int(bitmask_table(words, n_blocks).sum()) * culling.RAYS_PER_PROGRAM * BLOCK,
    )


def union_search(scene, o, d, alive, tab: Tables | None = None):
    """The union walk, dead lanes masked (as the JAX tool's ``union_search``)."""
    tab = tab or tables(scene, o, d, alive)
    accel = scene.accel
    dst, idx = search_union(o, d, tab.words, tab.flags, accel.packed_plane,
                            accel.orig_idx)
    return masked(alive, dst, idx)


def frame_workloads(scene, width: int, height: int, n: int, seed: int = 0):
    """``{name: (o, d, alive)}``: the front and centre slices of ``n`` primary
    rays and the compacted secondary front of the whole frame."""
    dev = scene.device
    o_all, d_all = primary_rays(Camera.look_at(device=dev), width, height)
    total = o_all.shape[0]
    n = min(n, total)
    mid = min(height // 2 * width, total - n)
    everyone = torch.ones((n,), dtype=torch.bool, device=dev)
    out = {"front": (o_all[:n], d_all[:n], everyone),
           "center": (o_all[mid:mid + n], d_all[mid:mid + n], everyone)}
    dst_f, idx_f = [], []
    for i in range(0, total, n):
        o, d = o_all[i:i + n], d_all[i:i + n]
        dd, ii = production(scene, o, d, torch.ones((o.shape[0],), dtype=torch.bool,
                                                    device=dev))
        dst_f.append(dd)
        idx_f.append(ii)
    dst_f, idx_f = torch.cat(dst_f), torch.cat(idx_f)
    hit = idx_f >= 0
    order = torch.argsort((~hit).to(torch.int8), stable=True)  # hits first
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn((total, 3), generator=gen).to(dev)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    o2 = (o_all + dst_f[:, None] * d_all)[order][:n].contiguous()
    out["secondary"] = (o2, v[order][:n].contiguous(), hit[order][:n].contiguous())
    return out


def compare(scene, name, o, d, alive, iters: int = 20) -> dict:
    """One workload: equality, pair counts and, on a card with ``iters``
    > 0, kernel times (each kernel then launches ``iters`` + 3 more times)."""
    accel = scene.accel
    tab = tables(scene, o, d, alive)
    dp, ip_ = production(scene, o, d, alive)
    du, iu = union_search(scene, o, d, alive, tab)
    row = {
        "workload": name, "rays": o.shape[0], "live": int(alive.sum()),
        "same_dst": torch.equal(dp.view(torch.int32), du.view(torch.int32)),
        "same_idx": torch.equal(ip_, iu),
        "packet_pairs": tab.packet_pairs, "union_pairs": tab.union_pairs,
        "route": search.route(scene.n_triangles, accel.n_blocks,
                              search.Knobs.read()).kernel,
    }
    if o.device.type != "cuda" or iters == 0:
        return row
    plane, oi = accel.packed_plane, accel.orig_idx
    row["bitmask_ms"] = cuda_ms(
        lambda: search_bitmask(o, d, tab.packet_words, plane, oi), iters)
    row["union_ms"] = cuda_ms(
        lambda: search_union(o, d, tab.words, tab.flags, plane, oi), iters)
    if accel.mxu_coeffs is not None:
        for prec in ("split3", "highest"):
            row[f"mxu_{prec}_ms"] = cuda_ms(
                lambda: search_mxu(o, d, tab.words, tab.flags, accel.mxu_coeffs,
                                   oi, prec, alive), iters)
    return row


def describe(row: dict) -> str:
    ms = lambda k: f"{row[k]:.4f} ms" if k in row else "not measured"
    per_pair = lambda k, pairs: (f"{row[k] * 1e6 / max(pairs, 1):.4f} ns"
                                 if k in row else "not measured")
    text = (
        f"== {row['workload']}: {row['rays']} rays ({row['live']} live); "
        f"union walk == production ({row['route']}) on live lanes: "
        f"dst {row['same_dst']} idx {row['same_idx']}\n"
        f"  tested pairs: per packet (K2) {row['packet_pairs']}, per program "
        f"union (K8, K9) {row['union_pairs']} "
        f"({row['union_pairs'] / max(row['packet_pairs'], 1):.3f}x)\n"
        f"  K2 bitmask {ms('bitmask_ms')}, K9 union {ms('union_ms')}; per "
        f"tested pair K2 {per_pair('bitmask_ms', row['packet_pairs'])}, K9 "
        f"{per_pair('union_ms', row['union_pairs'])}"
    )
    if "mxu_split3_ms" in row:
        text += (f"\n  K8 on the same union words: split3 {ms('mxu_split3_ms')} "
                 f"({per_pair('mxu_split3_ms', row['union_pairs'])} per pair), "
                 f"highest {ms('mxu_highest_ms')} "
                 f"({per_pair('mxu_highest_ms', row['union_pairs'])} per pair)")
    return text


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raytracingc_tpu_torch.tools.union_walk_ab",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--triangles", default=BOX_SCENE, help="triangles.txt scene")
    p.add_argument("--tessellate", type=int, default=5, metavar="LEVELS")
    p.add_argument("-s", "--size", nargs=2, type=int, default=[1920, 1080],
                   metavar=("W", "H"))
    p.add_argument("--rays", type=int, default=262144, help="rays per workload")
    p.add_argument("--iters", type=int, default=20,
                   help="timed calls per kernel (0: check only, not timed)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    scene = load_scene(args.triangles, args.tessellate, device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"scene: {os.path.basename(args.triangles)} tessellated {args.tessellate} "
          f"levels, {scene.n_triangles} triangles ({scene.accel.n_blocks} blocks); "
          f"frame {args.size[0]}x{args.size[1]}; device {where}", flush=True)
    ok = True
    for name, (o, d, alive) in frame_workloads(scene, *args.size, args.rays).items():
        row = compare(scene, name, o, d, alive, args.iters)
        ok &= row["same_dst"] and row["same_idx"]
        print(describe(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
