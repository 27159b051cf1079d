"""``triangles.txt`` custom scene format.

Numpy only: the same code as ``raytracingc_tpu/scene/triangles_txt.py``,
kept in the port because importing any module of the JAX package imports
jax.

The reference's two-pass parser (``raytracing.c:19-98``) first rewrites the
file replacing every character that isn't ``0-9 - . + \\n`` with a space and
stripping ``//`` line comments (``cleanFile``, ``raytracing.c:47-74``), then
``fscanf``-reads an integer triangle count followed by 14 floats per triangle:
nine vertex coordinates (A, B, C), three albedo components, emission strength,
and smoothness. The face normal is computed counter-clockwise as
``normalize(cross(B - A, C - A))`` (``raytracing.c:24``).

We reproduce the same tokenization in memory (no ``.parsed`` temp file needed),
including its quirk that scientific-notation floats are destroyed ('e' becomes
a space).
"""

from __future__ import annotations

import re

import numpy as np

_KEEP = set("0123456789-.+\n")


def _clean(text: str) -> str:
    """Reference ``cleanFile`` semantics (``raytracing.c:47-74``), in memory."""
    text = re.sub(r"//[^\n]*", "", text)
    return "".join(c if c in _KEEP else " " for c in text)


def load_triangles_txt(path: str):
    """Parse a triangles.txt scene.

    Returns ``(verts [T,3,3], normals [T,3], albedo [T,3], emission [T],
    smoothness [T])`` as float32 numpy arrays.
    """
    with open(path, "r", errors="replace") as fh:
        tokens = _clean(fh.read()).split()
    if not tokens:
        raise ValueError(f"{path}: no numeric tokens found")
    count = int(float(tokens[0]))
    need = 1 + 14 * count
    if len(tokens) < need:
        raise ValueError(
            f"{path}: declared {count} triangles but only "
            f"{(len(tokens) - 1) // 14} are fully specified"
        )
    data = np.array([float(t) for t in tokens[1:need]], np.float32).reshape(count, 14)
    verts = data[:, 0:9].reshape(count, 3, 3)
    albedo = data[:, 9:12]
    emission = data[:, 12]
    smoothness = data[:, 13]
    ab = verts[:, 1] - verts[:, 0]
    ac = verts[:, 2] - verts[:, 0]
    normals = np.cross(ab, ac)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(norm == 0, 1.0, norm)
    return (
        verts.astype(np.float32),
        normals.astype(np.float32),
        albedo.astype(np.float32),
        emission.astype(np.float32),
        smoothness.astype(np.float32),
    )
