"""Numpy bridge: the JAX package's scene and camera arrays → the port's objects.

The caller turns each JAX array into numpy (``np.asarray``) and passes the
fields by name; the port never sees a ``jax.Array``. This is how the tests
make both packages compute on the same scene::

    tri = {f: np.asarray(getattr(js.triangles, f)) for f in TRIANGLE_FIELDS}
    sph = {f: np.asarray(getattr(js.spheres, f)) for f in SPHERE_FIELDS}
    env = {f: np.asarray(getattr(js.env, f)) for f in ENV_FIELDS}
    scene = scene_from_numpy(tri, sph, env, js.n_triangles, js.n_spheres)

:func:`accel_from_numpy` carries the JAX scene's ``TriangleAccel`` across
the same way (``accel_arrays`` shows the fields), and :func:`scene_to_numpy`
goes the other way, for round-trip checks. :func:`leaf_arrays` carries a
JAX Scene-shaped pytree (a scene, or ``jax.grad``'s gradient of one) into
the port's named leaves, and :func:`pose_arrays` a JAX camera's pose
parameters, so that gradients compare leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.ops.accel import TriangleAccel
from raytracingc_tpu_torch.scene.types import (
    LEAF_PATHS,
    EnvParams,
    Scene,
    Spheres,
    Triangles,
)

TRIANGLE_FIELDS = tuple(f.name for f in dataclasses.fields(Triangles))
SPHERE_FIELDS = tuple(f.name for f in dataclasses.fields(Spheres))
ENV_FIELDS = tuple(f.name for f in dataclasses.fields(EnvParams))
CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))
# The accel's array fields (besides its ``triangles``) and their dtypes;
# the optional ones are None on a trivial accel.
ACCEL_FIELDS = {
    "orig_idx": np.int32, "aabb_lo": np.float32, "aabb_hi": np.float32,
    "mxu_coeffs": np.float32, "perm_of_orig": np.int32,
    "packed_plane": np.float32,
}
_OPTIONAL_ACCEL_FIELDS = ("mxu_coeffs", "perm_of_orig", "packed_plane")


def _build(cls, fields: tuple[str, ...], arrays: Mapping[str, np.ndarray], device):
    missing = set(fields) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{
        f: torch.from_numpy(np.array(arrays[f], np.float32)).to(device)
        for f in fields
    })


def accel_arrays(accel) -> dict:
    """A JAX-package ``TriangleAccel`` as the numpy dict that
    :func:`accel_from_numpy` takes (``triangles`` a dict of its fields).
    Takes anything with the accel's attributes; imports nothing of JAX."""
    out = {"triangles": {f: np.asarray(getattr(accel.triangles, f))
                         for f in TRIANGLE_FIELDS}}
    for f in ACCEL_FIELDS:
        v = getattr(accel, f)
        out[f] = None if v is None else np.asarray(v)
    return out


def accel_from_numpy(arrays: Mapping, device="cpu") -> TriangleAccel:
    """Build a port ``TriangleAccel`` from the JAX accel's fields, as numpy."""
    missing = {"triangles", *ACCEL_FIELDS} - set(arrays)
    if missing:
        raise KeyError(f"TriangleAccel: missing fields {sorted(missing)}")
    fields = {}
    for f, dtype in ACCEL_FIELDS.items():
        v = arrays[f]
        if v is None and f not in _OPTIONAL_ACCEL_FIELDS:
            raise ValueError(f"TriangleAccel: {f} is None")
        fields[f] = None if v is None else torch.from_numpy(
            np.array(v, dtype)).to(device)
    return TriangleAccel(
        triangles=_build(Triangles, TRIANGLE_FIELDS, arrays["triangles"], device),
        **fields,
    )


def scene_from_numpy(triangles: Mapping[str, np.ndarray],
                     spheres: Mapping[str, np.ndarray],
                     env: Mapping[str, np.ndarray],
                     n_triangles: int, n_spheres: int, device="cpu") -> Scene:
    """Build a port ``Scene`` from the JAX scene's fields, as numpy."""
    return Scene(
        triangles=_build(Triangles, TRIANGLE_FIELDS, triangles, device),
        spheres=_build(Spheres, SPHERE_FIELDS, spheres, device),
        env=_build(EnvParams, ENV_FIELDS, env, device),
        n_triangles=int(n_triangles),
        n_spheres=int(n_spheres),
    )


def camera_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> Camera:
    """Build a port ``Camera`` from ``origin``, ``ex``, ``ey``, ``ez``, ``fov``."""
    return _build(Camera, CAMERA_FIELDS, arrays, device)


def scene_to_numpy(scene: Scene) -> dict:
    """``{"triangles": {...}, "spheres": {...}, "env": {...}, "n_triangles",
    "n_spheres"}`` with numpy arrays, the inverse of :func:`scene_from_numpy`."""
    host = lambda obj, fields: {
        f: getattr(obj, f).detach().cpu().numpy() for f in fields
    }
    return {
        "triangles": host(scene.triangles, TRIANGLE_FIELDS),
        "spheres": host(scene.spheres, SPHERE_FIELDS),
        "env": host(scene.env, ENV_FIELDS),
        "n_triangles": scene.n_triangles,
        "n_spheres": scene.n_spheres,
    }


def leaf_arrays(tree) -> dict[str, np.ndarray]:
    """``{".triangles.a": ..., ...}``: the :data:`LEAF_PATHS` leaves of
    anything shaped like the JAX package's Scene pytree (a scene or a
    gradient of one), as numpy. Imports nothing of JAX."""
    out = {}
    for name in LEAF_PATHS:
        _, group, field = name.split(".")
        out[name] = np.asarray(getattr(getattr(tree, group), field))
    return out


def pose_arrays(pose) -> dict[str, np.ndarray]:
    """The camera pose parameters of ``fit_camera``, ``{"origin", "dir"}``
    as numpy, from the JAX package's params dict (or its gradient) or from
    a camera (``origin`` and ``ez``)."""
    if isinstance(pose, Mapping):
        return {k: np.asarray(pose[k]) for k in ("origin", "dir")}
    return {"origin": np.asarray(pose.origin), "dir": np.asarray(pose.ez)}

