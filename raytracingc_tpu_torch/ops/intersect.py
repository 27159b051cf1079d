"""Ray–primitive intersection: search (which primitive wins) + resolve.

Counterpart of ``raytracingc_tpu/ops/intersect.py``. The search finds, per
ray, only the winning primitive (an index and flags) and runs under
``torch.no_grad()``; the triangle pass goes through the dispatch in
``ops/search.py`` (a CUDA kernel, or its plain version on the CPU), with the
scene's accel. The resolve gathers the winner and recomputes distance, hit
point, normal and material with the same formulas.

Tie rules are the C scan order: the lowest index wins among equal
distances, and a sphere beats a triangle at equal distance (spheres are
scanned first and a triangle replaces only on a strictly smaller distance).

A block-sharded scene (``Scene.shard``: each rank of a process group holds a
contiguous slice of the triangle buffers) searches its own slice on the
accel-table routes, whose ``orig_idx`` are global indices (a trivial accel's
and the plain scan's are local and are made global), and merges the ranks'
winners with one ``all_reduce(MIN)`` over the 64-bit ``(bits(dst) << 32 |
idx)`` keys that the item kernels merge through: the same (distance, lowest
index) rule, so the merged winner equals a whole-scene search bit for bit.
The resolve gathers the winner's row on the rank that owns it, zeros on the
others, and sums across the group (``raytracingc_tpu/ops/intersect.py``'s
masked ``psum``).

Each search is one ``rtc.search`` span (dispatch, kernel launch, spheres,
merge) and each resolve one ``rtc.resolve`` span.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from raytracingc_tpu_torch.ops.search import search_triangles
from raytracingc_tpu_torch.ops.search_range import MISS_KEY, pack_keys, unpack_keys
from raytracingc_tpu_torch.scene.types import EPSILON, MISS_DST, Scene
from raytracingc_tpu_torch.utils.profiling import trace_annotation


@dataclasses.dataclass(frozen=True)
class HitRef:
    """Per-ray search result: which primitive was hit (no geometry)."""

    hit: torch.Tensor  # bool [R]
    is_tri: torch.Tensor  # bool [R] (valid only where hit)
    idx: torch.Tensor  # int32 [R] primitive index, -1 on a miss


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray resolved hit: geometry and material of the winner."""

    hit: torch.Tensor  # bool [R]
    dst: torch.Tensor  # f32 [R], MISS_DST on a miss
    point: torch.Tensor  # f32 [R, 3]
    normal: torch.Tensor  # f32 [R, 3]
    albedo: torch.Tensor  # f32 [R, 3]
    emission: torch.Tensor  # f32 [R]
    smoothness: torch.Tensor  # f32 [R]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of products over the last axis of 3, in component order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def ray_triangle_dst(o, d, a, b, c, n):
    """Möller–Trumbore with backface cull on the stored normal ``n``.

    All arguments broadcast; returns ``(dst, valid)``. ``dst`` is finite
    everywhere (the division is guarded) and meaningful only where valid.
    """
    ab = b - a
    ac = c - a
    backface = _dot(d, n) >= 0.0
    h = _cross(d, ac)
    det = _dot(ab, h)
    degenerate = det.abs() < EPSILON
    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    s = o - a
    u = _dot(s, h) * inv_det
    q = _cross(s, ab)
    v = _dot(d, q) * inv_det
    dst = _dot(ac, q) * inv_det
    valid = (
        ~backface & ~degenerate & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
        & (u + v <= 1.0) & (dst >= EPSILON)
    )
    return dst, valid


def ray_sphere_dst(o, d, center, radius):
    """Ray–sphere quadratic for unit directions; returns ``(dst, valid)``.

    The near root is preferred, the far one taken when the near one is
    behind ``EPSILON``. Non-positive radii (padding) never hit.
    """
    offset = o - center
    b = _dot(offset, d)
    cc = _dot(offset, offset) - radius * radius
    delta = b * b - cc
    miss = delta < 0.0
    sq = torch.sqrt(torch.where(miss, 0.0, delta))
    near = -b - sq
    far = -b + sq
    dst = torch.where(near < EPSILON, far, near)
    valid = ~miss & (dst >= EPSILON) & (radius > 0.0)
    return dst, valid


def _search_spheres(o, d, spheres):
    """Full ``[R, S]`` pass (sphere counts are tiny); lowest index wins ties."""
    dst, valid = ray_sphere_dst(
        o[:, None, :], d[:, None, :], spheres.center[None], spheres.radius[None]
    )
    dst = torch.where(valid, dst, MISS_DST)
    dmin, idx = dst.min(dim=1)  # first minimum
    return dmin, torch.where(dmin < MISS_DST, idx.to(torch.int32), -1)


@torch.no_grad()
def nearest_hit(o, d, scene: Scene, backend: str = "auto", alive=None) -> HitRef:
    """Closest-hit search over the whole scene → ``HitRef``.

    ``backend``: see :func:`ops.search.search_triangles`.
    ``alive``: optional bool ``[R]``; a dead lane may get a miss or its real
    hit, depending on the kernel the search routes to (see
    :func:`ops.search.search_triangles`), so callers never read dead lanes.
    A block-sharded scene (``scene.shard``) merges its ranks' winners (module
    docstring); every rank of the group must call this with the same rays.
    """
    with trace_annotation("rtc.search"):
        r = o.shape[0]
        shard = scene.shard
        n_live = scene.n_triangles
        if shard is not None:  # the live rows of this rank's slice
            lo = shard.rank * scene.triangles.count
            n_live = min(max(n_live - lo, 0), scene.triangles.count)
        tri_dst, tri_idx = search_triangles(
            o, d, scene.triangles, n_live, alive=alive, backend=backend,
            accel=scene.accel, packet_only=shard is not None,
        )
        if shard is not None:
            if scene.accel is None or backend == "xla":  # local indices
                tri_idx = torch.where(tri_idx >= 0, tri_idx + lo, tri_idx)
            keys = torch.where(tri_idx >= 0, pack_keys(tri_dst, tri_idx), MISS_KEY)
            dist.all_reduce(keys, op=dist.ReduceOp.MIN, group=shard.group)
            tri_dst, tri_idx = unpack_keys(keys)
        if scene.n_spheres > 0:
            sph_dst, sph_idx = _search_spheres(o, d, scene.spheres)
        else:
            sph_dst = torch.full((r,), MISS_DST, dtype=torch.float32, device=o.device)
            sph_idx = torch.full((r,), -1, dtype=torch.int32, device=o.device)

        # Triangles are scanned after spheres in the C loop, so they win only on
        # a strictly smaller distance.
        is_tri = tri_dst < sph_dst
        best = torch.where(is_tri, tri_dst, sph_dst)
        idx = torch.where(is_tri, tri_idx, sph_idx)
        hit = best < MISS_DST
        return HitRef(hit=hit, is_tri=is_tri, idx=torch.where(hit, idx, -1))


# Padded triangle count from which RTC_RESOLVE=auto resolves through the
# Morton-permuted table (the JAX package's value, measured on a TPU).
PERM_RESOLVE_MIN_T = 500_000


def _tri_table(tris) -> torch.Tensor:
    """``(T, 17)`` resolve rows: A, B, C, N, albedo, emission, smoothness."""
    return torch.cat(
        [tris.a, tris.b, tris.c, tris.normal, tris.albedo,
         tris.emission[:, None], tris.smoothness[:, None]],
        dim=1,
    )


def with_perm_resolve(scene: Scene) -> Scene:
    """Attach the Morton-permuted ``(T, 17)`` resolve table.

    Winners of nearby rays are spatially near, hence near in the accel's
    Morton order: gathering their rows from the permuted table reads nearby
    rows. The rows are copies of the original-order rows, so the resolve
    gives the same bits. ``RTC_RESOLVE``: ``auto`` (default) attaches the
    table from :data:`PERM_RESOLVE_MIN_T` padded triangles, ``perm`` always,
    ``orig`` never. No-op without an accel carrying ``perm_of_orig``, at
    <= 256 triangles, for a block-sharded scene (its resolve gathers from its
    own slice) or when a table is already attached.
    """
    mode = os.environ.get("RTC_RESOLVE", "auto")
    if mode not in ("auto", "perm", "orig"):
        raise ValueError(f"RTC_RESOLVE={mode!r}: expected 'auto', 'perm' or 'orig'")
    accel = scene.accel
    count = scene.triangles.count
    if (
        mode == "orig"
        or (mode == "auto" and count < PERM_RESOLVE_MIN_T)
        or accel is None
        or accel.perm_of_orig is None
        or count <= 256
        or scene.shard is not None
        or scene.resolve_perm is not None
    ):
        return scene
    # Padding slots carry a huge orig_idx: clipped to the last row, never
    # selected.
    rows = _tri_table(scene.triangles)[accel.orig_idx.long().clamp_max(count - 1)]
    return dataclasses.replace(scene, resolve_perm=rows)


def _sharded_rows(scene: Scene, tri_sel, tri_idx) -> torch.Tensor:
    """The winners' ``(R, 17)`` rows of a block-sharded scene: each rank
    gathers the rows of the winners in its slice, zeros the others', and the
    group sums them (a row plus zeros: the replicated gather's values)."""
    t = scene.triangles.count
    lo = scene.shard.rank * t
    mine = tri_sel & (tri_idx >= lo) & (tri_idx < lo + t)
    rows = torch.where(mine[:, None],
                       _tri_table(scene.triangles)[torch.where(mine, tri_idx - lo, 0)],
                       0.0)
    if rows.requires_grad:
        raise ValueError("a block-sharded scene is forward-only: its resolve "
                         "sums across ranks outside autograd")
    dist.all_reduce(rows, group=scene.shard.group)
    return rows


def resolve_hit(o, d, ref: HitRef, scene: Scene) -> Hit:
    """Recompute (dst, point, normal, material) for the winning primitive.

    Lanes that did not win a triangle gather triangle row 0 and lanes that
    did not win a sphere gather sphere row 0; both branches stay finite and
    the unselected one is discarded. A block-sharded scene gathers on the
    rank that owns the winner and sums across the group (module docstring);
    it is forward-only.
    """
    with trace_annotation("rtc.resolve"):
        tri_sel = ref.hit & ref.is_tri
        sph_sel = ref.hit & ~ref.is_tri
        tri_idx = torch.where(tri_sel, ref.idx, 0).long()
        sph_idx = torch.where(sph_sel, ref.idx, 0).long()
        sph = scene.spheres

        if scene.resolve_perm is not None:  # see with_perm_resolve
            slot = scene.accel.perm_of_orig[tri_idx.clamp_max(scene.triangles.count - 1)]
            tri_rows = scene.resolve_perm[slot.long()]
        elif scene.shard is not None:
            tri_rows = _sharded_rows(scene, tri_sel, tri_idx)
        else:
            tri_rows = _tri_table(scene.triangles)[tri_idx]  # (R, 17)
        a = tri_rows[:, 0:3]
        b = tri_rows[:, 3:6]
        c = tri_rows[:, 6:9]
        ab = b - a
        ac = c - a
        h = _cross(d, ac)
        det = _dot(ab, h)
        # Guard at the search's EPSILON: a winning triangle has |det| >= EPSILON,
        # so this only keeps unselected lanes finite.
        inv_det = 1.0 / torch.where(det.abs() < EPSILON, 1.0, det)
        q = _cross(o - a, ab)
        tri_dst = _dot(ac, q) * inv_det
        tri_normal = tri_rows[:, 9:12]

        sph_rows = torch.cat(
            [sph.center, sph.radius[:, None], sph.albedo,
             sph.emission[:, None], sph.smoothness[:, None]],
            dim=1,
        )[sph_idx]  # (R, 9)
        center = sph_rows[:, 0:3]
        radius = sph_rows[:, 3]
        safe_radius = torch.where(radius > 0.0, radius, 1.0)
        offset = o - center
        bq = _dot(offset, d)
        delta = bq * bq - (_dot(offset, offset) - safe_radius * safe_radius)
        sq = torch.sqrt(torch.clamp_min(delta, 1e-20))
        sph_dst = torch.where(-bq - sq < EPSILON, -bq + sq, -bq - sq)

        dst = torch.where(tri_sel, tri_dst, torch.where(sph_sel, sph_dst, MISS_DST))
        point = o + d * dst[:, None]  # computed even on a miss, as the C code does
        sph_normal = (point - center) / safe_radius[:, None]
        normal = torch.where(tri_sel[:, None], tri_normal, sph_normal)
        normal = torch.where(ref.hit[:, None], normal, 0.0)

        albedo = torch.where(tri_sel[:, None], tri_rows[:, 12:15], sph_rows[:, 4:7])
        emission = torch.where(tri_sel, tri_rows[:, 15], sph_rows[:, 7])
        smoothness = torch.where(tri_sel, tri_rows[:, 16], sph_rows[:, 8])
        return Hit(
            hit=ref.hit,
            dst=dst,
            point=point,
            normal=normal,
            albedo=torch.where(ref.hit[:, None], albedo, 0.0),
            emission=torch.where(ref.hit, emission, 0.0),
            smoothness=torch.where(ref.hit, smoothness, 0.0),
        )


def intersect(o, d, scene: Scene, backend: str = "auto") -> Hit:
    """Search and resolve in one call: ``resolve_hit`` of ``nearest_hit``."""
    return resolve_hit(o, d, nearest_hit(o, d, scene, backend=backend), scene)
