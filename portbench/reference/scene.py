"""The scene a configuration states, built in plain numpy and torch.

A configuration file (``portbench/configs/<name>.json``) names a
``triangles.txt`` scene, the spheres, the camera and the environment light.
This module reads them without the program: the file format of
RayTracingC's default scene mode (a triangle count, then 14 numbers a
triangle: A, B, C, albedo, emission, smoothness; ``//`` comments; every
character outside ``0-9 - . + newline`` is a separator), the face normal
``normalize(cross(B - A, C - A))``, the y-down look-at camera and the sun
direction normalised in float32.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

_KEEP = set("0123456789-.+\n")


def parse_triangles_txt(path: str):
    """``(verts [T, 3, 3], normals, albedo, emission, smoothness)``, float32."""
    with open(path, errors="replace") as fh:
        text = re.sub(r"//[^\n]*", "", fh.read())
    tokens = "".join(c if c in _KEEP else " " for c in text).split()
    count = int(float(tokens[0]))
    data = np.array([float(t) for t in tokens[1:1 + 14 * count]],
                    np.float32).reshape(count, 14)
    verts = data[:, 0:9].reshape(count, 3, 3)
    normals = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(norm == 0, 1.0, norm)
    return (verts.astype(np.float32), normals.astype(np.float32),
            data[:, 9:12].copy(), data[:, 12].copy(), data[:, 13].copy())


@dataclasses.dataclass
class RefScene:
    """Triangles ``a, b, c, normal, albedo [T, 3], emission, smoothness
    [T]``; spheres ``center [S, 3], radius [S], s_albedo [S, 3],
    s_emission, s_smoothness [S]``; ``env``, the sky and sun parameters."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    smoothness: torch.Tensor
    center: torch.Tensor
    radius: torch.Tensor
    s_albedo: torch.Tensor
    s_emission: torch.Tensor
    s_smoothness: torch.Tensor
    env: dict

    def replace(self, **kw) -> "RefScene":
        return dataclasses.replace(self, **kw)

    def cast(self, dtype) -> "RefScene":
        """Every float tensor in ``dtype`` (the lower-precision control)."""
        conv = {f.name: getattr(self, f.name).to(dtype)
                for f in dataclasses.fields(self) if f.name != "env"}
        return dataclasses.replace(
            self, env={k: v.to(dtype) for k, v in self.env.items()}, **conv)


def env_params(env: dict, device) -> dict:
    sun = np.asarray(env["sun_direction"], np.float32)
    sun = sun / np.linalg.norm(sun)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return {"sun_direction": f32(sun), "sky_horizon": f32(env["sky_horizon"]),
            "sky_zenith": f32(env["sky_zenith"]), "ground": f32(env["ground"]),
            "sun_focus": f32(env["sun_focus"]),
            "sun_intensity": f32(env["sun_intensity"])}


def scene_arrays(config: dict, root: str):
    """The configuration's triangles as float32 numpy arrays."""
    return parse_triangles_txt(f"{root}/{config['scene']}")


def build_scene(config: dict, root: str, device, arrays=None) -> RefScene:
    """The configuration's scene on ``device`` (``arrays``: the triangles
    of :func:`scene_arrays`, perturbed by a traffic mix, say)."""
    verts, normals, albedo, emission, smoothness = (
        arrays if arrays is not None else scene_arrays(config, root))
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
    # No spheres: one of radius 0, which no ray hits.
    sph = config["spheres"] or [{"center": [0.0] * 3, "radius": 0.0, "albedo": [0.0] * 3,
                                 "emission": 0.0, "smoothness": 0.0}]
    return RefScene(
        a=t(verts[:, 0]), b=t(verts[:, 1]), c=t(verts[:, 2]), normal=t(normals),
        albedo=t(albedo), emission=t(emission), smoothness=t(smoothness),
        center=t([s["center"] for s in sph]).reshape(-1, 3),
        radius=t([s["radius"] for s in sph]),
        s_albedo=t([s["albedo"] for s in sph]).reshape(-1, 3),
        s_emission=t([s["emission"] for s in sph]),
        s_smoothness=t([s["smoothness"] for s in sph]),
        env=env_params(config["env"], device),
    )


def _normalize(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    return v / torch.sqrt(x * x + y * y + z * z).unsqueeze(-1)


def primary_rays(origin, target, fov: float, width: int, height: int, device):
    """``(origins, dirs)`` ``[H*W, 3]``, row-major, y = 0 at the top, of the
    y-down look-at camera: ``ez = normalize(target - origin)``, ``ex =
    normalize(ez x (0, -1, 0))``, ``ey = normalize(ez x ex)``, pixel ``(x,
    y)`` looking along ``dx ex + dy ey + fov ez`` with ``dx = (x - W//2) /
    (H//2)``, ``dy = (y - H//2) / (H//2)`` (C integer divisions)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    origin, target, fov = f32(origin), f32(target), f32(fov)
    ez = _normalize(target - origin)
    up = f32([0.0, -1.0, 0.0])
    ex = _normalize(torch.linalg.cross(ez, up))
    ey = _normalize(torch.linalg.cross(ez, ex))
    half_w, half_h = width // 2, max(height // 2, 1)
    xs = (torch.arange(width, dtype=torch.float32, device=device) - half_w) / half_h
    ys = (torch.arange(height, dtype=torch.float32, device=device) - half_h) / half_h
    dx, dy = xs.repeat(height), ys.repeat_interleave(width)
    dirs = _normalize(dx[:, None] * ex[None, :] + dy[:, None] * ey[None, :]
                      + fov * ez[None, :])
    return origin.expand_as(dirs).contiguous(), dirs
