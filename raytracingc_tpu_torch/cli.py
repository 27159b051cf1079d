"""Command-line entry point: the JAX package's CLI, ported.

Same flags, spellings and defaults as ``raytracingc_tpu/cli.py``, plus
``--device {cuda,cpu}`` (default ``cuda``; a missing card raises, nothing
falls back to the CPU). ``--backend``: ``auto`` runs the CUDA kernels on a
card and their plain versions on the CPU, ``xla`` the accel-free plain scan
on either device, ``pallas`` the CUDA kernels (raises on the CPU). Scenes
carry the block-AABB accel, rebuilt after ``--tessellate``.
``--checkpoint FILE --batch-spp N`` renders progressively (resumable),
``--debug-bounces`` the bounce-count heatmap, ``--trace DIR`` writes a
torch.profiler Chrome trace of the run into DIR.

``--shard pixels|samples`` renders across the ranks of a
``torch.distributed`` world (``raytracingc_tpu_torch.parallel``), with
``--scene-sharding blocks`` the triangle buffers block-sharded over them. A
world of several processes: start one CLI process per rank with the same
flags plus ``--coordinator HOST:PORT --num-processes N --process-id I``;
``--dist-backend`` (the port's flag) picks the collectives' backend, NCCL on
cards by default and gloo on the CPU (several ranks on one card need gloo:
NCCL refuses them). Rank 0 alone writes the image and prints the summary.
Without those flags a sharded run is a world of one rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracingc-tpu-torch",
        description="Path tracer on PyTorch and CUDA "
        "(same capabilities as RayTracingC).",
    )
    p.add_argument("-i", "--input", default=None, metavar="path/to/file.obj",
                   help=".obj scene; omit for default mode (triangles.txt + sphere)")
    p.add_argument("-o", "--output", default="out.bmp", help="output image (.bmp/.png)")
    p.add_argument("-p", "--pos", nargs=3, type=float, default=[-4.75, -1.5, -4.75],
                   metavar=("X", "Y", "Z"), help="camera position")
    p.add_argument("-t", "--track", nargs=3, type=float, default=[0.9, -1.2, 1.0],
                   metavar=("X", "Y", "Z"), help="look-at point")
    p.add_argument("-f", "--fov", type=float, default=1.0,
                   help="focal-length scalar (bigger = narrower FOV)")
    p.add_argument("-s", "--size", nargs=2, type=int, default=[128, 128],
                   metavar=("W", "H"), help="image size")
    p.add_argument("-b", "--max-bounce", type=int, default=10, help="max path length")
    p.add_argument("-gc", "--ground-color", nargs=3, type=float,
                   default=[0.66, 0.66, 0.66], metavar=("R", "G", "B"))
    p.add_argument("-sch", "--sky-color-horizon", nargs=3, type=float,
                   default=[1.0, 1.0, 1.0], metavar=("R", "G", "B"))
    p.add_argument("-scz", "--sky-color-zenith", nargs=3, type=float,
                   default=[0.263, 0.969, 0.871], metavar=("R", "G", "B"))
    p.add_argument("--sun", nargs=5, type=float,
                   default=[-30.0, -85.0, 100.0, 22.0, 0.75],
                   metavar=("X", "Y", "Z", "FOCUS", "INTENSITY"))
    # Extensions over the C CLI:
    p.add_argument("--spp", type=int, default=4000,
                   help="samples per pixel (the reference hard-codes 4000)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--triangles", default="triangles.txt",
                   help="triangles.txt path for default mode")
    p.add_argument("--backend", choices=["auto", "xla", "pallas"], default="auto",
                   help="triangle search: auto (CUDA kernels on a card, plain "
                   "versions on the CPU), xla (plain scan), pallas (CUDA kernels)")
    p.add_argument("--tessellate", type=int, default=0, metavar="LEVELS",
                   help="midpoint-subdivide the scene 4^LEVELS-fold before "
                   "rendering (same image, more triangles)")
    p.add_argument("--shard", choices=["none", "pixels", "samples"], default="none",
                   help="shard the render over the world's ranks by pixels or "
                   "by samples")
    p.add_argument("--scene-sharding", choices=["replicated", "blocks"],
                   default="replicated",
                   help="with --shard: replicate the triangle buffers on every "
                   "rank (default) or block-shard them 1/n per pixel rank "
                   "(bit-matched winners)")
    p.add_argument("--pixel-chunk", type=int, default=None,
                   help="pixels traced per step (memory bound)")
    p.add_argument("--profile", action="store_true", help="print timing breakdown")
    p.add_argument("--debug-bounces", action="store_true",
                   help="render the bounce-count heatmap instead of radiance "
                        "(the reference's calcDebugColor)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a torch.profiler trace (Chrome format) to DIR")
    p.add_argument("--checkpoint", metavar="FILE.npz", default=None,
                   help="progressive sample-batch checkpointing (resumable)")
    p.add_argument("--batch-spp", type=int, default=64,
                   help="samples per checkpoint batch (with --checkpoint)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: host:port of process 0's store (give "
                   "all three of these flags)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: ranks in the world")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's rank; rank 0 alone "
                   "writes the image and prints the summary")
    # The port's own flags:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to render; 'cuda' with no card raises (each "
                   "rank takes card local_rank %% device_count)")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="collective backend of a multi-process world (default "
                   "nccl with --device cuda, gloo with --device cpu; several "
                   "ranks on one card need gloo)")
    return p


def _world_flags(args: argparse.Namespace) -> bool:
    """Whether the multi-process flags ask for a world; raises ``SystemExit``
    unless they are all given or all absent."""
    given = [args.coordinator is not None, args.num_processes is not None,
             args.process_id is not None]
    if any(given) and not all(given):
        raise SystemExit("--coordinator, --num-processes and --process-id go "
                         "together (torch.distributed discovers no world)")
    if args.dist_backend is not None and not all(given):
        raise SystemExit("--dist-backend needs --coordinator, --num-processes "
                         "and --process-id")
    return all(given)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.scene_sharding != "replicated" and (
        args.shard == "none" or args.checkpoint or args.debug_bounces
    ):
        # The JAX package's guard: only the plain sharded render honours
        # block sharding.
        raise SystemExit(
            "--scene-sharding blocks requires --shard pixels|samples and "
            "is not supported with --checkpoint/--debug-bounces"
        )
    world = _world_flags(args)

    import torch

    from raytracingc_tpu_torch.utils.profiling import start_trace, stop_trace

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    if args.device == "cpu" and args.backend == "pallas":
        raise SystemExit("--backend pallas runs the CUDA kernel: it needs --device cuda")
    device = torch.device(args.device)
    if world:
        import torch.distributed as dist

        from raytracingc_tpu_torch.parallel.mesh import (
            default_backend,
            initialize_distributed,
            rank_device,
        )

        try:
            initialize_distributed(args.coordinator, args.num_processes,
                                   args.process_id,
                                   args.dist_backend or default_backend(args.device))
        except ValueError as e:
            raise SystemExit(str(e)) from None
        device = rank_device(args.device)

    if args.trace:
        start_trace(args.trace)
    try:
        _run(args, device)
    finally:
        if args.trace:
            path = stop_trace()
            print(f"[trace] profile written to {path}")
        if world and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _run(args: argparse.Namespace, device) -> None:
    import numpy as np
    import torch.distributed as dist

    from raytracingc_tpu_torch.camera import Camera
    from raytracingc_tpu_torch.render.image import tonemap_to_bytes, write_image
    from raytracingc_tpu_torch.render.integrator import render_debug
    from raytracingc_tpu_torch.render.progressive import render_progressive
    from raytracingc_tpu_torch.render.renderer import render
    from raytracingc_tpu_torch.scene.builder import (
        scene_from_obj,
        scene_from_triangles_txt,
        tessellate,
    )
    from raytracingc_tpu_torch.scene.types import EnvParams

    t0 = time.time()
    env = EnvParams.from_values(
        args.sun[:3], args.sky_color_horizon, args.sky_color_zenith,
        args.ground_color, args.sun[3], args.sun[4],
    )
    if args.input is None:
        print(f"Starting raytracingc-tpu-torch in default mode ({args.triangles})")
        scene = scene_from_triangles_txt(args.triangles, env=env)
    else:
        print(f"Starting raytracingc-tpu-torch in OBJ mode ({args.input})")
        scene = scene_from_obj(args.input, env=env)
    if args.tessellate > 0:
        tris, n_live = tessellate(
            scene.triangles, scene.n_triangles, levels=args.tessellate
        )
        scene = dataclasses.replace(
            scene, triangles=tris, n_triangles=n_live, accel=None
        ).with_accel()
    if args.scene_sharding == "replicated":
        # A block-sharded render takes each rank's slice from the host.
        scene = scene.to(device)
    t_load = time.time() - t0
    print(f"Scene: {scene.n_triangles} triangles, {scene.n_spheres} spheres "
          f"(loaded in {t_load:.2f}s)")

    cam = Camera.look_at(origin=args.pos, target=args.track, fov=args.fov,
                         device=device)
    width, height = args.size
    shard = None if args.shard == "none" else args.shard

    t1 = time.time()
    if args.debug_bounces:
        linear = render_debug(scene, cam, width, height,
                              max_bounce=args.max_bounce, seed=args.seed,
                              backend=args.backend)
        count = width * height
    elif args.checkpoint:
        # --shard composes with --checkpoint: each batch renders across the
        # ranks and rank 0 checkpoints the sum between batches.
        linear, count = render_progressive(
            scene, cam, width, height, spp=args.spp,
            max_bounce=args.max_bounce, seed=args.seed, backend=args.backend,
            batch_spp=args.batch_spp, checkpoint_path=args.checkpoint,
            shard_strategy=shard, device=device,
        )
    elif shard is None:
        linear, count = render(
            scene, cam, width, height, spp=args.spp, max_bounce=args.max_bounce,
            seed=args.seed, backend=args.backend, pixel_chunk=args.pixel_chunk,
        )
    else:
        from raytracingc_tpu_torch.parallel.sharded import (
            mesh_for_strategy,
            pad_scene_for_blocks,
            render_sharded,
            strategy_spp_dim,
        )

        mesh = mesh_for_strategy(shard, device_type=device.type)
        if args.scene_sharding == "blocks":
            n = mesh.size()
            scene = pad_scene_for_blocks(scene, n // strategy_spp_dim(shard, n))
        linear, count = render_sharded(
            scene, cam, width, height, spp=args.spp, max_bounce=args.max_bounce,
            seed=args.seed, backend=args.backend, mesh=mesh,
            scene_sharding=args.scene_sharding, pixel_chunk=args.pixel_chunk,
        )
    linear = linear.cpu().numpy()  # waits for the device
    t_render = time.time() - t1
    if not np.isfinite(linear).all():
        raise RuntimeError("the render produced non-finite radiance")
    if dist.is_initialized() and dist.get_rank() != 0:
        return  # every rank holds the whole image; rank 0 writes it

    write_image(args.output, tonemap_to_bytes(linear))
    rays = float(count)
    print(f"Rendered {width}x{height} @ {args.spp} spp, {args.max_bounce} bounces "
          f"in {t_render:.2f}s — {rays:.3g} rays traced "
          f"({rays / max(t_render, 1e-9):.3g} rays/s) → {args.output}")
    if args.profile:
        print(f"[profile] load={t_load:.3f}s render={t_render:.3f}s "
              f"rays={count} device={device}")


if __name__ == "__main__":
    sys.exit(main())
