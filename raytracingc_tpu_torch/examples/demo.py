"""The procedural demo scene: a floor, a back wall and an emissive ceiling
quad (y-down world) with the reference's hard-coded sphere.

The port's own copy of ``__graft_entry__._demo_scene`` (the JAX package's
compile-check entry point, which the port does not import), built with the
same arrays: the same triangle rows, normals, materials, padding and live
counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracingc_tpu_torch.scene.builder import (
    default_spheres,
    pad_spheres,
    triangles_from_arrays,
)
from raytracingc_tpu_torch.scene.types import EnvParams, Scene

# (corner, edge1, edge2, albedo, emission, smoothness) of each quad.
QUADS = (
    ((-5, 2, -5), (10, 0, 0), (0, 0, 10), (0.8, 0.6, 0.9), 0.0, 0.1),  # floor
    ((-5, 2, 5), (10, 0, 0), (0, -7, 0), (0.9, 0.9, 0.9), 0.0, 0.5),  # back
    ((-2, -4.5, -2), (4, 0, 0), (0, 0, 4), (1.0, 1.0, 1.0), 8.0, 0.0),  # light
)


def demo_scene(device="cpu") -> Scene:
    """Two triangles per quad of :data:`QUADS`, CCW normals as the
    triangles.txt loader computes them, padded to 128 rows; the default
    sphere padded to 8; the default environment; no accel."""
    verts, albedo, emission, smooth = [], [], [], []
    for corner, e1, e2, col, emi, smo in QUADS:
        a = np.array(corner, np.float32)
        b = a + np.array(e1, np.float32)
        c = a + np.array(e2, np.float32)
        d = b + np.array(e2, np.float32)
        for tri in ((a, b, c), (b, d, c)):
            verts.append(np.stack(tri))
            albedo.append(col)
            emission.append(emi)
            smooth.append(smo)
    verts = np.stack(verts)
    normals = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    tris, n_live = triangles_from_arrays(
        verts, normals.astype(np.float32), np.array(albedo, np.float32),
        np.array(emission, np.float32), np.array(smooth, np.float32))
    spheres, n_sph = pad_spheres(default_spheres(), pad_to=8)
    scene = Scene(triangles=tris, spheres=spheres, env=EnvParams.default(),
                  n_triangles=n_live, n_spheres=n_sph)
    return scene.to(device)


def built(triangles, spheres, env) -> Scene:
    """The JAX package's ``Scene.build``: every triangle and sphere row
    live (padding rows included), no accel."""
    return Scene(triangles=triangles, spheres=spheres, env=env,
                 n_triangles=triangles.count, n_spheres=spheres.count)


def sun_env(direction, focus: float, intensity: float) -> EnvParams:
    """The default environment with the sun along ``direction`` (normalized
    in float32), ``focus`` and ``intensity``."""
    import torch

    sun = np.array(direction, np.float32)
    sun /= np.linalg.norm(sun)
    return dataclasses.replace(
        EnvParams.default(), sun_direction=torch.from_numpy(sun),
        sun_focus=torch.tensor(focus, dtype=torch.float32),
        sun_intensity=torch.tensor(intensity, dtype=torch.float32))
