"""Camera-pose inverse rendering: recover origin and view direction from pixels.

Counterpart of ``examples/inverse_camera.py``: perturb the camera's origin
(by ~0.18) and view direction (by ~0.05 rad) on the demo scene, then
recover both from the L2 image loss with ``fit_camera``, whose parameters
are the origin and the unit view direction (a look-at point's distance
along the view is pure gauge).

    python -m raytracingc_tpu_torch.examples.inverse_camera [--device cuda]
        [--steps 250] [--size 40] [--spp 2] [--max-bounce 2]

:func:`main` returns ``(losses, pose error before, pose error after)``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from raytracingc_tpu_torch.camera import Camera, look_at_basis, primary_rays
from raytracingc_tpu_torch.diff import fit_camera
from raytracingc_tpu_torch.examples.demo import demo_scene
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.tools import device_arg

TRUE_ORIGIN = (-4.75, -1.5, -4.75)
TRUE_LOOK = (0.9, -1.2, 1.0)


def pose_error(cam: Camera, cam_true: Camera) -> float:
    """L2 pose metric: |Δorigin| + |Δ(unit view direction)|."""
    return float((cam.origin - cam_true.origin).norm()
                 + (cam.ez - cam_true.ez).norm())


def perturbed(cam_true: Camera) -> Camera:
    """The origin moved by (0.12, -0.08, 0.1), the view direction tilted by
    (-0.03, 0.025, 0.035) and renormalized."""
    dev = cam_true.origin.device
    pert_dir = cam_true.ez + torch.tensor([-0.03, 0.025, 0.035], device=dev)
    pert_dir = pert_dir / pert_dir.norm()
    origin0 = cam_true.origin + torch.tensor([0.12, -0.08, 0.1], device=dev)
    ex, ey, ez = look_at_basis(origin0, origin0 + pert_dir)
    return dataclasses.replace(cam_true, origin=origin0, ex=ex, ey=ey, ez=ez)


def main(steps: int = 250, size: int = 40, spp: int = 2, max_bounce: int = 2,
         device="cuda"):
    device = device_arg(device)
    scene = demo_scene(device)
    cam_true = Camera.look_at(TRUE_ORIGIN, TRUE_LOOK, device=device)
    o, d = primary_rays(cam_true, size, size)
    ids = torch.arange(size * size, device=scene.device)
    target, _ = trace_accumulate(o, d, scene, ids, seed=0, spp=spp,
                                 max_bounce=max_bounce)
    target = target.reshape(size, size, 3)

    cam0 = perturbed(cam_true)
    e0 = pose_error(cam0, cam_true)
    print(f"perturbed pose error: {e0:.4f}")
    fitted, losses = fit_camera(scene, target, cam0, steps=steps,
                                learning_rate=1e-2, spp=spp,
                                max_bounce=max_bounce, seed=0)
    e1 = pose_error(fitted, cam_true)
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    print(f"pose error {e0:.4f} -> {e1:.4f} ({e0 / e1:.1f}x recovery)")
    print(f"origin err {float((fitted.origin - cam_true.origin).norm()):.4f}")
    return losses, e0, e1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--size", type=int, default=40)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--max-bounce", type=int, default=2)
    args = ap.parse_args()
    main(args.steps, args.size, args.spp, args.max_bounce, args.device)
