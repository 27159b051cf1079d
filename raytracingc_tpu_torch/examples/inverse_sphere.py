"""Sphere-geometry inverse rendering: recover a sphere's center from pixels.

Counterpart of ``examples/inverse_sphere.py``: a glossy sphere
(smoothness 0.9) under a sharp sun (focus 200) over one diffuse floor
triangle; perturb the sphere's center and recover it from the L2 image loss
with ``fit_scene(trainable=["spheres.center"])``. The sphere search is a
plain full pass, so the triangle accel stays as it is.

    python -m raytracingc_tpu_torch.examples.inverse_sphere [--device cuda]
        [--steps 250]

:func:`main` returns ``(losses, center error before, center error after)``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.diff import fit_scene
from raytracingc_tpu_torch.examples.demo import built, sun_env
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.builder import triangles_from_arrays
from raytracingc_tpu_torch.scene.types import Scene, Spheres
from raytracingc_tpu_torch.tools import device_arg


def make_scene(offset=(0.0, 0.0, 0.0), device="cpu") -> Scene:
    """Glossy sphere over a diffuse floor, lit by a sharp sun."""
    env = sun_env([0.4, -1.0, -0.6], 200.0, 5.0)
    # One diffuse floor triangle (y-down world: y=1.5 is below the sphere).
    verts = np.array([[[-8, 1.5, -8], [0, 1.5, 8], [8, 1.5, -8]]], np.float32)
    n = np.array([[0, -1, 0]], np.float32)
    tris, _ = triangles_from_arrays(
        verts, n, np.full((1, 3), 0.6, np.float32),
        np.zeros(1, np.float32), np.zeros(1, np.float32))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    spheres = Spheres(
        center=f32([[0.0 + offset[0], -0.2 + offset[1], 3.0 + offset[2]]]),
        radius=f32([1.0]), albedo=torch.full((1, 3), 0.9),
        emission=torch.zeros(1), smoothness=f32([0.9]))
    return built(tris, spheres, env).with_accel().to(device)


def main(steps: int = 250, perturb=(0.15, -0.12, 0.2), device="cuda"):
    device = device_arg(device)
    cam = Camera.look_at(origin=[0.0, -0.5, 0.0], target=[0.0, -0.2, 3.0],
                         device=device)
    w = h = 32
    true_scene = make_scene(device=device)
    target, _ = render(true_scene, cam, w, h, spp=4, max_bounce=3, seed=0,
                       early_exit=False)
    start = make_scene(perturb, device)
    c0 = float((start.spheres.center - true_scene.spheres.center).norm())
    print(f"perturbed center error: {c0:.4f}")
    fitted, losses = fit_scene(
        start, target, cam, steps=steps, learning_rate=5e-3, spp=4,
        max_bounce=3, seed=0, trainable=["spheres.center"],
        log_every=max(steps // 5, 1))
    c1 = float((fitted.spheres.center - true_scene.spheres.center).norm())
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    print(f"center error {c0:.4f} -> {c1:.4f} ({c0 / c1:.1f}x recovery)")
    return losses, c0, c1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=250)
    args = ap.parse_args()
    main(args.steps, device=args.device)
