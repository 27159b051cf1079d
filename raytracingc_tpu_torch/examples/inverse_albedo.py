"""Inverse rendering: recover a perturbed wall's albedo from a target image.

Counterpart of ``examples/inverse_albedo.py``: render box_scene's ground
truth, corrupt the back wall's albedo (triangles 2-3 of
``examples/box_scene.txt``; one wall seen head-on is identifiable from one
view), then descend the L2 image loss back with ``fit_scene``, the other
leaves' gradients zeroed.

    python -m raytracingc_tpu_torch.examples.inverse_albedo [--device cuda]
        [--sharded] [--steps 80] [--size 16] [--spp 8] [--out DIR]

``--sharded`` trains over a ``parallel.make_mesh`` mesh of every rank of the
world (one rank without one). Writes ``target``, ``corrupted`` and
``recovered`` PNGs (64 spp) into ``--out`` (default: ``inverse_albedo``
under the temporary directory). Exits 0 if the wall's mean albedo error
fell.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.diff import fit_scene
from raytracingc_tpu_torch.render.image import tonemap_to_bytes, write_image
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
from raytracingc_tpu_torch.tools import BOX_SCENE, device_arg

WALL = slice(2, 4)  # the back wall's two triangles
# The JAX example's noise on those rows: jax.random.uniform(PRNGKey(0),
# albedo.shape, minval=-0.35, maxval=0.35)[2:4] (float32; every other row
# is multiplied by 0).
WALL_NOISE = tuple(tuple(float.fromhex(x) for x in row) for row in (
    ("-0x1.101ae2p-3", "0x1.0fa3aap-3", "0x1.61c3bap-3"),
    ("-0x1.d7a230p-3", "0x1.5be6d0p-2", "-0x1.544704p-2"),
))


def corrupt(truth):
    """The truth scene with the wall's albedo moved by :data:`WALL_NOISE`,
    every row then clipped to [0.02, 0.98] (as the JAX example clips)."""
    albedo = truth.triangles.albedo
    noise = torch.zeros_like(albedo)
    noise[WALL] = torch.tensor(WALL_NOISE, dtype=albedo.dtype)
    wall = torch.zeros_like(albedo)
    wall[WALL] = 1.0
    return dataclasses.replace(truth, triangles=dataclasses.replace(
        truth.triangles, albedo=(albedo + noise * wall).clamp(0.02, 0.98)))


def wall_albedo_only(grads: dict) -> dict:
    """Every gradient zeroed but the wall rows of the triangles' albedo."""
    out = {k: torch.zeros_like(g) for k, g in grads.items()}
    wall = torch.zeros_like(grads[".triangles.albedo"])
    wall[WALL] = 1.0
    out[".triangles.albedo"] = grads[".triangles.albedo"] * wall
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--sharded", action="store_true",
                    help="train over a parallel.make_mesh mesh")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "inverse_albedo"))
    args = ap.parse_args(argv)
    device = device_arg(args.device)

    truth = scene_from_triangles_txt(BOX_SCENE).to(device)
    cam = Camera.look_at(origin=(0.0, -1.5, -5.5), target=(0.0, 0.0, 6.0),
                         device=device)
    w = h = args.size
    target, _ = render(truth, cam, w, h, spp=args.spp, max_bounce=3, seed=11,
                       early_exit=False)
    corrupted = corrupt(truth)

    mesh = None
    if args.sharded:
        from raytracingc_tpu_torch.parallel import make_mesh
        from raytracingc_tpu_torch.parallel.mesh import mesh_shape

        mesh = make_mesh(device_type=device.type)
        px, spp = mesh_shape(mesh)
        print(f"mesh: {{'px': {px}, 'spp': {spp}}} over {px * spp} ranks")

    fitted, losses = fit_scene(
        corrupted, target, cam, steps=args.steps, learning_rate=5e-2,
        spp=args.spp, max_bounce=3, seed=11, param_filter=wall_albedo_only,
        mesh=mesh, log_every=10)
    err = lambda s: float((s.triangles.albedo - truth.triangles.albedo)[WALL]
                          .abs().mean())
    err0, err1 = err(corrupted), err(fitted)
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"mean |albedo err| {err0:.4f} -> {err1:.4f}")

    os.makedirs(args.out, exist_ok=True)
    for name, sc in (("target", truth), ("corrupted", corrupted),
                     ("recovered", fitted)):
        img, _ = render(sc, cam, w, h, spp=64, max_bounce=3, seed=3)
        write_image(os.path.join(args.out, f"{name}.png"),
                    tonemap_to_bytes(img.cpu().numpy()))
    print(f"wrote {args.out}/{{target,corrupted,recovered}}.png")
    return 0 if err1 < err0 else 1


if __name__ == "__main__":
    sys.exit(main())
