"""Vertex-geometry inverse rendering: recover a translated mirror triangle.

Counterpart of ``examples/inverse_vertices.py``: radiance depends on vertex
positions only through ray-path geometry (flat diffuse walls give
visibility-only signal), so light goes camera → a trainable MIRROR triangle
→ a mirror sphere → the sun-lit sky, whose sharp lobe (focus 100) turns the
triangle's depth into strong smooth image gradients. The triangle is moved
by +0.08 along z and recovered from the L2 image loss with
``fit_scene(trainable=["triangles.a", "triangles.b", "triangles.c"])``,
only the vertices' z components updated; the fitted scene carries an accel
rebuilt for the new geometry.

    python -m raytracingc_tpu_torch.examples.inverse_vertices [--device cuda]
        [--steps 80]

:func:`main` returns ``(losses, vertex L1 before, vertex L1 after)``.
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

VERTICES = (".triangles.a", ".triangles.b", ".triangles.c")


def make_scene(dz: float, device="cpu") -> Scene:
    """One big mirror triangle at z = 3 + dz, facing a mirror sphere."""
    env = sun_env([0.3, -1.0, -0.5], 100.0, 3.0)
    s = 16.0
    verts = np.array([[[-s, -s, 3.0 + dz], [0, s, 3.0 + dz], [s, -s, 3.0 + dz]]],
                     np.float32)
    n = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    tris, _ = triangles_from_arrays(
        verts, n, np.full((1, 3), 0.9, np.float32),
        np.zeros(1, np.float32), np.ones(1, np.float32))  # smoothness 1
    spheres = Spheres(
        center=torch.tensor([[0.4, -0.9, -2.0]]), radius=torch.tensor([1.5]),
        albedo=torch.full((1, 3), 0.9), emission=torch.zeros(1),
        smoothness=torch.ones(1))
    return built(tris, spheres, env).with_accel().to(device)


def vertex_l1(scene: Scene, true_scene: Scene) -> float:
    """Sum of |Δ| over the first triangle's three vertices."""
    return sum(float((getattr(scene.triangles, f) - getattr(true_scene.triangles, f))
                     [:1].abs().sum()) for f in ("a", "b", "c"))


def z_translation_filter(grads: dict) -> dict:
    """Vertex positions only, and only their z components: rigid depth
    recovery (x/y gradients would tilt the plane away from its frozen
    stored normal, which stalls the loss)."""
    out = {k: torch.zeros_like(g) for k, g in grads.items()}
    for k in VERTICES:
        out[k] = grads[k] * torch.tensor([0.0, 0.0, 1.0], device=grads[k].device)
    return out


def main(steps: int = 80, perturb: float = 0.08, device="cuda"):
    device = device_arg(device)
    cam = Camera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0],
                         device=device)
    w = h = 32
    true_scene = make_scene(0.0, device)
    target, _ = render(true_scene, cam, w, h, spp=4, max_bounce=4, seed=0,
                       early_exit=False)
    start = make_scene(perturb, device)
    l1_0 = vertex_l1(start, true_scene)
    print(f"perturbed by dz={perturb}: vertex L1 = {l1_0:.4f}")
    fitted, losses = fit_scene(
        start, target, cam, steps=steps, learning_rate=2e-3, spp=4,
        max_bounce=4, seed=0, trainable=["triangles.a", "triangles.b",
                                         "triangles.c"],
        param_filter=z_translation_filter, log_every=max(steps // 8, 1))
    l1_1 = vertex_l1(fitted, true_scene)
    z = torch.cat([getattr(fitted.triangles, f)[:1, 2] for f in ("a", "b", "c")])
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    print(f"vertex L1 {l1_0:.4f} -> {l1_1:.4f} "
          f"({100 * (1 - l1_1 / l1_0):.0f}% recovered)")
    print(f"vertex z after fit: {z.cpu().numpy()} (truth 3.0)")
    if fitted.accel is None:
        raise AssertionError("the accel must be rebuilt after a geometry fit")
    return losses, l1_0, l1_1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args()
    main(args.steps, device=args.device)
