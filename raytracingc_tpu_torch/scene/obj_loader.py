"""Wavefront OBJ/MTL ingest.

Numpy only: the same code as ``raytracingc_tpu/scene/obj_loader.py``,
kept in the port because importing any module of the JAX package imports
jax.

Behavioral contract (matching the reference loader, ``objloader.c``):

* Vertices (``v``) and vertex normals (``vn``) are 1-indexed
  (``objloader.c:446-480``); only ``f v/vt/vn`` triplet faces are supported
  (``objloader.c:488``). ``f v//vn`` faces are a hard error in the reference
  (``exit(69)``, ``objloader.c:518-521``); here they raise ``ValueError``.
  Faces with more than three vertex groups are silently truncated to the first
  three, exactly as the reference's ``sscanf`` pattern does.
* The face normal is taken from the FIRST vertex's ``vn`` index — flat shading
  (``objloader.c:499``).
* ``mtllib`` paths resolve relative to the .obj's directory
  (``objloader.c:342-345,401-410``); a missing .mtl file is a warning, not an
  error (``objloader.c:234-240``), leaving zero materials loaded.
* ``usemtl`` does a linear name lookup; unknown names select the default
  material: white albedo, zero emission, zero smoothness
  (``objloader.c:413-430,501-506``, ``DEFAULT_COLOR`` at ``objloader.c:36``).
* MTL mapping (``objloader.c:246-306``): ``Kd r g b`` → albedo; ``Ke r g b`` →
  only the FIRST component is kept, as a scalar emission strength; ``Ns n`` →
  ``smoothness = sqrt(0.001 * n)`` (Ns 1000 → mirror 1.0). Ka/Ks/Ni/d/illum are
  ignored. Divergence: the reference leaves fields of materials that never set
  them as uninitialized heap memory; we initialize to the default material.

Textures, ``vp``, line elements, smooth-shading groups and ``[w]`` coordinates
are unsupported here as in the reference (``objloader.c:21``).
"""

from __future__ import annotations

import os
import re
import sys
from dataclasses import dataclass, field

import numpy as np

_FACE_GROUP = re.compile(r"^(-?\d+)/(-?\d+)/(-?\d+)$")
_FACE_NOTEX = re.compile(r"^(-?\d+)//(-?\d+)$")

DEFAULT_ALBEDO = (1.0, 1.0, 1.0)


@dataclass
class ObjMaterial:
    name: str
    albedo: tuple[float, float, float] = DEFAULT_ALBEDO
    emission: float = 0.0
    smoothness: float = 0.0


@dataclass
class ObjMesh:
    """Raw parse result, before any renderer coordinate convention is applied."""

    verts: np.ndarray  # [T, 3, 3] float32 — A, B, C per face
    normals: np.ndarray  # [T, 3] float32 — flat face normal (from first vn)
    albedo: np.ndarray  # [T, 3] float32
    emission: np.ndarray  # [T] float32
    smoothness: np.ndarray  # [T] float32
    materials: list[ObjMaterial] = field(default_factory=list)

    @property
    def count(self) -> int:
        return self.verts.shape[0]


def load_mtl(path: str, verbose: bool = False) -> list[ObjMaterial]:
    """Parse a .mtl file into a material list (see module docstring)."""
    materials: list[ObjMaterial] = []
    try:
        fh = open(path, "r", errors="replace")
    except OSError:
        if verbose:
            print("WARNING: No material found.", file=sys.stderr)
        return materials
    with fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl" and len(parts) >= 2:
                materials.append(ObjMaterial(name=parts[1]))
            elif not materials:
                continue  # attributes before any newmtl are ignored
            elif key == "Ns" and len(parts) >= 2:
                ns = float(parts[1])
                materials[-1].smoothness = float(np.sqrt(np.float32(0.001) * np.float32(ns)))
            elif key == "Kd" and len(parts) >= 4:
                materials[-1].albedo = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif key == "Ke" and len(parts) >= 2:
                materials[-1].emission = float(parts[1])
    return materials


def load_obj(path: str, verbose: bool = False) -> ObjMesh:
    """Parse a .obj file into flat-shaded triangle soup (see module docstring)."""
    verts: list[tuple[float, float, float]] = []
    norms: list[tuple[float, float, float]] = []
    materials: list[ObjMaterial] = []
    current_mtl = -1  # -1 = default material, like ``objloader.c:51``

    tri_verts: list[np.ndarray] = []
    tri_normals: list[tuple[float, float, float]] = []
    tri_albedo: list[tuple[float, float, float]] = []
    tri_emission: list[float] = []
    tri_smoothness: list[float] = []

    obj_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as fh:
        for lineno, raw in enumerate(fh, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]

            if key == "mtllib" and len(parts) >= 2:
                materials = load_mtl(os.path.join(obj_dir, parts[1]), verbose=verbose)
            elif key == "usemtl" and len(parts) >= 2:
                current_mtl = next(
                    (i for i, m in enumerate(materials) if m.name == parts[1]), -1
                )
            elif key == "v" and len(parts) >= 4:
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vn" and len(parts) >= 4:
                norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "f":
                groups = parts[1:4]  # extra vertices are ignored (sscanf semantics)
                if len(groups) < 3:
                    raise ValueError(f"{path}:{lineno}: face with <3 vertices: {line!r}")
                idx: list[tuple[int, int]] = []
                for g in groups:
                    m = _FACE_GROUP.match(g)
                    if m is None:
                        if _FACE_NOTEX.match(g):
                            raise ValueError(
                                f"{path}:{lineno}: 'f v//vn' faces are unsupported "
                                f"(reference exits with code 69 here): {line!r}"
                            )
                        raise ValueError(f"{path}:{lineno}: unparseable face: {line!r}")
                    idx.append((int(m.group(1)), int(m.group(3))))
                try:
                    a = verts[idx[0][0] - 1]
                    b = verts[idx[1][0] - 1]
                    c = verts[idx[2][0] - 1]
                    n = norms[idx[0][1] - 1]  # flat normal from FIRST vertex's vn
                except IndexError as e:
                    raise ValueError(f"{path}:{lineno}: face index out of range") from e
                tri_verts.append(np.array([a, b, c], dtype=np.float32))
                tri_normals.append(n)
                if 0 <= current_mtl < len(materials):
                    mat = materials[current_mtl]
                    tri_albedo.append(mat.albedo)
                    tri_emission.append(mat.emission)
                    tri_smoothness.append(mat.smoothness)
                else:
                    tri_albedo.append(DEFAULT_ALBEDO)
                    tri_emission.append(0.0)
                    tri_smoothness.append(0.0)
            # 'o', 's', 'vt', 'g', 'l' and friends: ignored, as in the reference.

    count = len(tri_verts)
    if verbose:
        print(f"Loaded {path}: {count} triangles, {len(materials)} materials")
    return ObjMesh(
        verts=(
            np.stack(tri_verts).astype(np.float32)
            if count
            else np.zeros((0, 3, 3), np.float32)
        ),
        normals=np.array(tri_normals, np.float32).reshape(count, 3),
        albedo=np.array(tri_albedo, np.float32).reshape(count, 3),
        emission=np.array(tri_emission, np.float32),
        smoothness=np.array(tri_smoothness, np.float32),
        materials=materials,
    )
