#!/usr/bin/env python3
"""Write Eric Haines' SPD ``tetra`` scene in the ``triangles.txt`` format.

    python3 portbench/configs/make_spd_tetra.py

writes ``portbench/configs/spd_tetra.txt``.

The Standard Procedural Databases (Haines, "A Proposal for Standard Graphics
Environments", IEEE CG&A 7(11), 1987) make each scene with a small program
whose one argument is a size factor. ``tetra`` is a Sierpinski tetrahedron:
the root is the regular tetrahedron with vertices (1, 1, 1), (1, -1, -1),
(-1, 1, -1), (-1, -1, 1); each level replaces a tetrahedron of center c and
half-size s by four of half-size s / 2 centered at c + (s / 2) v_i; at the
last level each tetrahedron is its four triangular faces. Size factor SF
gives 4^SF tetrahedra, 4^(SF + 1) triangles.

Here the root's half-size is 64, so at SF <= 6 every coordinate is an
integer in [-64, 64] (exact in float32), and the source's z axis, taken as
its up, is turned onto the program's up, -y: (x, y, z) -> (x, -z, y), a
rotation, which keeps every winding. Each face is wound so that
``cross(B - A, C - A)`` points away from its tetrahedron's center: the
program culls back faces. Sub-tetrahedra meet only at vertices, so no two
faces overlap. Every face is matte (smoothness 0) with the albedo
``ALBEDO`` and no emission. The output is deterministic: the committed
``spd_tetra.txt`` is this program's output at SF 6.
"""

from __future__ import annotations

import os

ROOT_VERTS = ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))
HALF_SIZE = 64  # the root's half-size: 2^SF divides it up to SF 6
ALBEDO = "0.75 0.75 0.75"
SIZE_FACTOR = 6
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spd_tetra.txt")


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return sum(x * y for x, y in zip(a, b))


def tetra_centers(size_factor: int):
    """``(centers, half-size)`` of the 4^SF leaf tetrahedra, in the
    recursion's order (child i of a tetrahedron before child i + 1), in the
    source's frame scaled by ``HALF_SIZE``."""
    if not 0 <= size_factor <= 6:
        raise ValueError(f"size factor {size_factor}: expected 0..6 (integer "
                         f"coordinates need 2^SF to divide {HALF_SIZE})")
    centers, s = [(0, 0, 0)], HALF_SIZE
    for _ in range(size_factor):
        s //= 2
        centers = [tuple(c + s * v for c, v in zip(cen, vi))
                   for cen in centers for vi in ROOT_VERTS]
    return centers, s


def faces(center, s):
    """The four faces of the tetrahedron of ``center`` and half-size ``s``:
    the face opposite vertex i, i = 0..3, each wound outward."""
    verts = [tuple(c + s * v for c, v in zip(center, vi)) for vi in ROOT_VERTS]
    out = []
    for i in range(4):
        a, b, c = (verts[j] for j in range(4) if j != i)
        if _dot(_cross(_sub(b, a), _sub(c, a)), _sub(a, center)) < 0:
            b, c = c, b
        out.append((a, b, c))
    return out


def turn(p):
    """The source's frame (z up) into the program's (y down)."""
    x, y, z = p
    return (x, -z, y)


def triangles(size_factor: int = SIZE_FACTOR):
    """Every triangle ``(A, B, C)`` of the scene, turned, in file order."""
    centers, s = tetra_centers(size_factor)
    return [tuple(turn(p) for p in tri) for c in centers for tri in faces(c, s)]


def scene_text(size_factor: int = SIZE_FACTOR) -> str:
    tris = triangles(size_factor)
    head = (
        f"// Eric Haines' SPD tetra at size factor {size_factor}: {4 ** size_factor} "
        f"tetrahedra, {len(tris)} triangles,\n"
        "// written by portbench/configs/make_spd_tetra.py. A triangle a line: A, B, C,\n"
        "// albedo, emission, smoothness; root half-size 64, the source's z turned onto -y.\n"
    )
    rows = [" ".join(" ".join(str(x) for x in p) for p in tri) + f"  {ALBEDO}  0 0"
            for tri in tris]
    return head + f"{len(tris)}\n" + "\n".join(rows) + "\n"


if __name__ == "__main__":
    with open(OUT, "w") as fh:
        fh.write(scene_text())
