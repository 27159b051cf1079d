"""Loader smoke-test entry point (the reference's ``objtest`` binary).

Counterpart of ``raytracingc_tpu/objtest.py``::

    python -m raytracingc_tpu_torch.objtest path/to/model.obj [--txt] [--native | --python]

parses the file with the C++ loader (``--native`` requires it; by default it
is used when it builds) or the Python loader (``--python``), prints a
summary (triangle count, bounds, normals, emissive triangles, and with the
Python OBJ loader the material table) and exits 1 on a parse error.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="raytracingc-tpu-torch-objtest")
    p.add_argument("path", help=".obj file (or triangles.txt with --txt)")
    p.add_argument("--txt", action="store_true", help="parse as triangles.txt")
    p.add_argument("--native", action="store_true",
                   help="require the native C++ loader")
    p.add_argument("--python", action="store_true",
                   help="force the pure-Python loader")
    args = p.parse_args(argv)

    from raytracingc_tpu_torch.scene import native

    use_native = not args.python and (args.native or native.available())
    try:
        if args.txt:
            if use_native:
                v, n, a, e, s = native.load_triangles_txt_native(args.path)
            else:
                from raytracingc_tpu_torch.scene.triangles_txt import load_triangles_txt

                v, n, a, e, s = load_triangles_txt(args.path)
            mats = None
        else:
            if use_native:
                v, n, a, e, s = native.load_obj_native(args.path)
                mats = None
            else:
                from raytracingc_tpu_torch.scene.obj_loader import load_obj

                mesh = load_obj(args.path, verbose=True)
                v, n, a, e, s = (mesh.verts, mesh.normals, mesh.albedo,
                                 mesh.emission, mesh.smoothness)
                mats = mesh.materials
    except (OSError, ValueError) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1

    t = v.shape[0]
    loader = "native C++" if use_native else "python"
    print(f"{args.path}: {t} triangles [{loader} loader]")
    if t:
        lo, hi = v.reshape(-1, 3).min(axis=0), v.reshape(-1, 3).max(axis=0)
        print(f"  bounds: [{lo[0]:.3g} {lo[1]:.3g} {lo[2]:.3g}] .. "
              f"[{hi[0]:.3g} {hi[1]:.3g} {hi[2]:.3g}]")
        print(f"  normals unit-length: "
              f"{bool(np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-3))}")
        print(f"  emissive triangles: {int((e > 0).sum())}; "
              f"smoothness range [{s.min():.3g}, {s.max():.3g}]")
    if mats is not None:
        for m in mats:
            print(f"  material {m.name!r}: albedo={m.albedo} "
                  f"emission={m.emission} smoothness={m.smoothness:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
