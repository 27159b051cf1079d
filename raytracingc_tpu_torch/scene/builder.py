"""Scene assembly: loaders → padded ``Scene``s of tensors.

Counterpart of ``raytracingc_tpu/scene/builder.py``. OBJ triangles get the
reference's rotZ(180°) import convention (x and y of positions AND normals
negated). Default mode (``triangles.txt``) adds the hard-coded sphere list.
Triangle counts are padded to a multiple of 128 with all-zero triangles and
sphere counts to a multiple of 8 with radius-0 spheres, exactly as the JAX
package pads, so both packages hold the same arrays. Both loaders attach the
block-AABB accel (``ops/accel.py``), as the JAX loaders do.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingc_tpu_torch.scene.obj_loader import load_obj
from raytracingc_tpu_torch.scene.triangles_txt import load_triangles_txt
from raytracingc_tpu_torch.scene.types import EnvParams, Scene, Spheres, Triangles


def default_spheres(device="cpu") -> Spheres:
    """The reference's hard-coded sphere list: white, at (0, 1, 0), radius 2.5."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return Spheres(
        center=f32([[0.0, 1.0, 0.0]]),
        radius=f32([2.5]),
        albedo=f32([[1.0, 1.0, 1.0]]),
        emission=f32([0.0]),
        smoothness=f32([0.0]),
    )


def _pad_axis0(x: np.ndarray, n: int) -> np.ndarray:
    return np.pad(x, [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def triangles_from_arrays(verts, normals, albedo, emission, smoothness,
                          pad_to: int = 128, device="cpu") -> tuple[Triangles, int]:
    """Padded ``Triangles``; returns ``(triangles, live_count)``."""
    t = verts.shape[0]
    tp = _round_up(t, pad_to)
    pad = lambda x: _pad_axis0(np.asarray(x, np.float32), tp)
    return (
        Triangles.from_numpy(
            pad(verts), pad(normals), pad(albedo), pad(emission),
            pad(smoothness), device=device,
        ),
        t,
    )


def pad_spheres(spheres: Spheres, pad_to: int = 8) -> tuple[Spheres, int]:
    """Pad with radius-0 spheres; returns ``(spheres, live_count)``."""
    s = spheres.count
    n = _round_up(s, pad_to) - s
    pad = lambda x: torch.cat([x, x.new_zeros((n, *x.shape[1:]))])
    return (
        Spheres(
            center=pad(spheres.center),
            radius=pad(spheres.radius),
            albedo=pad(spheres.albedo),
            emission=pad(spheres.emission),
            smoothness=pad(spheres.smoothness),
        ),
        s,
    )


def _load_obj_arrays(path: str, verbose: bool, use_native: bool | None):
    """OBJ parse through the native C++ loader when it builds, else Python."""
    if use_native is not False:
        from raytracingc_tpu_torch.scene import native

        if native.available():
            return native.load_obj_native(path)
        if use_native:
            raise RuntimeError(
                f"native loader requested but not built ({native.build_error})")
    mesh = load_obj(path, verbose=verbose)
    return mesh.verts, mesh.normals, mesh.albedo, mesh.emission, mesh.smoothness


def scene_from_obj(path: str, env: EnvParams | None = None, pad_to: int = 128,
                   verbose: bool = False, device="cpu",
                   use_native: bool | None = None) -> Scene:
    """Load an OBJ scene. OBJ mode is triangles only.

    ``use_native``: ``None`` takes the C++ loader (``scene/native.py``) when
    it builds, ``True`` requires it, ``False`` forces the Python parser;
    both give the same arrays.
    """
    verts0, normals0, albedo, emission, smoothness = _load_obj_arrays(
        path, verbose, use_native)
    verts = verts0.copy()
    normals = normals0.copy()
    # rotZ(180°) import convention.
    verts[:, :, 0] *= -1.0
    verts[:, :, 1] *= -1.0
    normals[:, 0] *= -1.0
    normals[:, 1] *= -1.0
    tris, n_live = triangles_from_arrays(
        verts, normals, albedo, emission, smoothness,
        pad_to=pad_to, device=device,
    )
    return Scene(
        triangles=tris,
        spheres=Spheres.zeros(8, device=device),
        env=env.to(device) if env is not None else EnvParams.default(device),
        n_triangles=n_live,
        n_spheres=0,
    ).with_accel()


def scene_from_triangles_txt(path: str, env: EnvParams | None = None,
                             include_default_spheres: bool = True,
                             pad_to: int = 128, device="cpu") -> Scene:
    """Load a triangles.txt scene; default mode includes the sphere list."""
    tris, n_live = triangles_from_arrays(
        *load_triangles_txt(path), pad_to=pad_to, device=device
    )
    if include_default_spheres:
        spheres, n_sph = pad_spheres(default_spheres(device), pad_to=8)
    else:
        spheres, n_sph = Spheres.zeros(8, device=device), 0
    return Scene(
        triangles=tris,
        spheres=spheres,
        env=env.to(device) if env is not None else EnvParams.default(device),
        n_triangles=n_live,
        n_spheres=n_sph,
    ).with_accel()


def tessellate(tris: Triangles, n_live: int, levels: int = 1) -> tuple[Triangles, int]:
    """Midpoint 4-way subdivision: ``n_live`` → ``4**levels * n_live`` triangles.

    Children inherit the parent's stored normal and material and tile the
    parent's surface, so the scene renders the same image with more
    triangles. Computed in numpy, as the JAX package does, so both give the
    same vertices.
    """
    host = lambda x: x[:n_live].detach().cpu().numpy().astype(np.float32)
    a, b, c = host(tris.a), host(tris.b), host(tris.c)
    nm, al = host(tris.normal), host(tris.albedo)
    em, sm = host(tris.emission), host(tris.smoothness)
    for _ in range(levels):
        ab, bc, ca = 0.5 * (a + b), 0.5 * (b + c), 0.5 * (c + a)
        # corner A, corner B, corner C, then the central triangle.
        a, b, c = (
            np.concatenate([a, ab, ca, ab]),
            np.concatenate([ab, b, bc, bc]),
            np.concatenate([ca, bc, c, ca]),
        )
        nm, al = np.tile(nm, (4, 1)), np.tile(al, (4, 1))
        em, sm = np.tile(em, 4), np.tile(sm, 4)
    return triangles_from_arrays(
        np.stack([a, b, c], axis=1), nm, al, em, sm, device=tris.a.device
    )
