"""Scene data model: plain dataclasses of float32 tensors.

Counterpart of ``raytracingc_tpu/scene/types.py``, with the same fields and
layouts (structure of arrays, triangles ``[T, 3]``, padded counts) so that a
scene converted from the JAX package through numpy compares like with like.
Padding triangles are all-zero (a zero normal fails the backface test) and
padding spheres have radius 0 (never hit), exactly as there.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from raytracingc_tpu_torch.ops.accel import TriangleAccel

# The reference's intersection epsilon and miss sentinel.
EPSILON = 1e-3
MISS_DST = 999999.0


def _f32(x, device) -> torch.Tensor:
    """A contiguous float32 tensor (a column of a vertex array is copied),
    as the kernels' tables are read."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device).contiguous()


def _to(obj, device):
    """Copy every tensor field of a dataclass to ``device``."""
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass(frozen=True)
class Triangles:
    """Triangle soup: vertices ``a/b/c [T, 3]``, stored face ``normal [T, 3]``
    (the backface cull uses it), ``albedo [T, 3]``, ``emission [T]``,
    ``smoothness [T]``."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    smoothness: torch.Tensor

    @property
    def count(self) -> int:
        return self.a.shape[0]

    @classmethod
    def from_numpy(cls, verts, normals, albedo, emission, smoothness,
                   device="cpu") -> "Triangles":
        """``verts [T, 3, 3]`` (A, B, C) plus per-triangle attributes."""
        verts = np.asarray(verts, np.float32)
        return cls(
            a=_f32(verts[:, 0], device),
            b=_f32(verts[:, 1], device),
            c=_f32(verts[:, 2], device),
            normal=_f32(normals, device),
            albedo=_f32(albedo, device),
            emission=_f32(emission, device),
            smoothness=_f32(smoothness, device),
        )

    def to(self, device) -> "Triangles":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Spheres:
    """Spheres: ``center [S, 3]``, ``radius [S]`` (<= 0 is padding, never
    hit), ``albedo [S, 3]``, ``emission [S]``, ``smoothness [S]``."""

    center: torch.Tensor
    radius: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    smoothness: torch.Tensor

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @classmethod
    def zeros(cls, n: int, device="cpu") -> "Spheres":
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
        z1 = torch.zeros((n,), dtype=torch.float32, device=device)
        return cls(center=z3, radius=z1, albedo=z3, emission=z1, smoothness=z1)

    def to(self, device) -> "Spheres":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Procedural sky/sun. The world is y-DOWN: the sky is at negative y."""

    sun_direction: torch.Tensor  # [3], normalized
    sky_horizon: torch.Tensor  # [3]
    sky_zenith: torch.Tensor  # [3]
    ground: torch.Tensor  # [3]
    sun_focus: torch.Tensor  # scalar
    sun_intensity: torch.Tensor  # scalar

    @classmethod
    def from_values(cls, sun_direction, sky_horizon, sky_zenith, ground,
                    sun_focus, sun_intensity, device="cpu") -> "EnvParams":
        """Build from plain numbers; ``sun_direction`` is normalized here."""
        sun = np.asarray(sun_direction, np.float32)
        sun = sun / np.linalg.norm(sun)
        return cls(
            sun_direction=_f32(sun, device),
            sky_horizon=_f32(sky_horizon, device),
            sky_zenith=_f32(sky_zenith, device),
            ground=_f32(ground, device),
            sun_focus=_f32(sun_focus, device),
            sun_intensity=_f32(sun_intensity, device),
        )

    @classmethod
    def default(cls, device="cpu") -> "EnvParams":
        return cls.from_values(
            [-30.0, -85.0, 100.0], [1.0, 1.0, 1.0], [0.263, 0.969, 0.871],
            [0.66, 0.66, 0.66], 22.0, 0.75, device=device,
        )

    def to(self, device) -> "EnvParams":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Where a block-sharded scene's triangles live: rank ``rank`` of the
    ``size`` ranks of the process group ``group`` (the mesh's ``px``
    dimension) holds the contiguous slice ``[rank * T, (rank + 1) * T)`` of
    every triangle buffer, ``T`` its own row count. The counterpart of the
    JAX package's static ``Scene.shard_axis``."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class Scene:
    """Geometry and environment. ``n_triangles``/``n_spheres`` are the live
    (unpadded) counts.

    ``accel`` optionally carries the Morton block-AABB structure of
    ``ops.accel.build_accel`` (a permuted copy of the triangles plus block
    bounds); the packet kernels search through it, with the same results as
    without. It does not follow edits of ``triangles``: change triangles
    through :meth:`with_triangles`. ``resolve_perm`` is the Morton-permuted
    resolve table that ``ops.intersect.with_perm_resolve`` attaches at
    integrator entry (``None``: the resolve gathers original-order rows).
    ``shard`` marks one rank's slice of a block-sharded scene
    (``parallel.sharded.render_sharded_blocks``): its triangle buffers and
    accel are that rank's contiguous rows, ``n_triangles`` the whole scene's
    live count, and the search and resolve merge across ``shard.group``.
    ``to`` keeps it.
    """

    triangles: Triangles
    spheres: Spheres
    env: EnvParams
    n_triangles: int
    n_spheres: int
    accel: TriangleAccel | None = None
    resolve_perm: torch.Tensor | None = None
    shard: ShardSpec | None = None

    def __post_init__(self):
        # The builders pad to >= 128 triangle rows and >= 8 sphere rows; the
        # resolve gathers row 0 of each table for lanes that did not select it.
        if self.triangles.count < 1 or self.spheres.count < 1:
            raise ValueError("a Scene needs >= 1 triangle row and >= 1 sphere row "
                             "(padding rows count)")
        # A block-sharded scene keeps the whole scene's live count.
        rows = self.triangles.count * (1 if self.shard is None else self.shard.size)
        if not 0 <= self.n_triangles <= rows:
            raise ValueError(f"n_triangles={self.n_triangles} outside [0, {rows}]")
        if not 0 <= self.n_spheres <= self.spheres.count:
            raise ValueError(
                f"n_spheres={self.n_spheres} outside [0, {self.spheres.count}]"
            )
        if self.accel is not None and self.accel.orig_idx.shape[0] != self.triangles.count:
            raise ValueError(
                f"accel covers {self.accel.orig_idx.shape[0]} triangle rows, "
                f"the scene has {self.triangles.count}"
            )
        if self.resolve_perm is not None and self.accel is None:
            raise ValueError("resolve_perm needs the accel whose order it has")
        if self.resolve_perm is not None and self.shard is not None:
            raise ValueError("a block-sharded scene resolves from its own slice; "
                             "it takes no resolve_perm")

    @property
    def device(self) -> torch.device:
        return self.triangles.a.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self,
            triangles=self.triangles.to(device),
            spheres=self.spheres.to(device),
            env=self.env.to(device),
            accel=None if self.accel is None else self.accel.to(device),
            resolve_perm=(None if self.resolve_perm is None
                          else self.resolve_perm.to(device)),
        )

    def with_accel(self) -> "Scene":
        """A copy carrying a freshly built block-AABB accel."""
        from raytracingc_tpu_torch.ops.accel import build_accel

        return dataclasses.replace(
            self, accel=build_accel(self.triangles, self.n_triangles),
            resolve_perm=None,
        )

    def with_triangles(self, triangles: Triangles,
                       rebuild_accel: bool = False) -> "Scene":
        """Replace the triangles, dropping (or rebuilding) the accel.

        As in the JAX package, ``n_triangles`` becomes ``triangles.count``.
        A bare ``dataclasses.replace(scene, triangles=...)`` would leave the
        accel's frozen copy of the old triangles in place.
        """
        out = dataclasses.replace(self, triangles=triangles, accel=None,
                                  resolve_perm=None,
                                  n_triangles=triangles.count)
        return out.with_accel() if rebuild_accel else out


# The scene's float leaves, named by their paths in the JAX package's Scene
# pytree (``jax.tree_util.keystr``): ".triangles.a" ... ".env.sun_intensity".
_LEAF_GROUPS = (("triangles", Triangles), ("spheres", Spheres), ("env", EnvParams))
LEAF_PATHS = tuple(f".{group}.{f.name}" for group, cls in _LEAF_GROUPS
                   for f in dataclasses.fields(cls))


def scene_leaves(scene: Scene) -> dict[str, torch.Tensor]:
    """The scene's parameter tensors by :data:`LEAF_PATHS` name, in the JAX
    package's flattening order (the accel and the resolve table, derived
    data, are not leaves)."""
    return {f".{group}.{f.name}": getattr(getattr(scene, group), f.name)
            for group, cls in _LEAF_GROUPS for f in dataclasses.fields(cls)}


def with_leaves(scene: Scene, leaves: dict[str, torch.Tensor]) -> Scene:
    """A copy of ``scene`` with the named leaves replaced (any subset of
    :data:`LEAF_PATHS`); the accel stays attached and the resolve table is
    dropped (``with_perm_resolve`` rebuilds it from the new triangles)."""
    unknown = set(leaves) - set(LEAF_PATHS)
    if unknown:
        raise KeyError(f"not scene leaves: {sorted(unknown)}")
    groups = {}
    for group, _ in _LEAF_GROUPS:
        new = {name.rsplit(".", 1)[1]: t for name, t in leaves.items()
               if name.startswith(f".{group}.")}
        if new:
            groups[group] = dataclasses.replace(getattr(scene, group), **new)
    return dataclasses.replace(scene, resolve_perm=None, **groups)

