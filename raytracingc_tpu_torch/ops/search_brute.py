"""Brute-force closest-hit triangle search: the CUDA kernel and its plain version.

Counterpart of ``raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_brute``
(with the dead-lane post-mask of its launcher). The kernel is
``csrc/search_brute.cu``; :func:`search_brute_reference` is its plain
PyTorch version with the same op order, used on CPU tensors and by the tests
and ``chip_smoke.py`` to hold the kernel against. :func:`mt_distance` is the
Möller–Trumbore arithmetic every plain search version shares (``csrc/mt.cuh``
on the card). Dispatch lives in ``ops/search.py``.

Triangles reach the kernel packed as ``[T, 12]`` float32 rows of A, AB, AC, N
(:func:`pack_triangles`), with AB and AC built as ``b - a`` and ``c - a`` as
the JAX launcher builds them, or as the scene's own vertex and normal
arrays (:func:`search_brute` given the :class:`Triangles`, the search
dispatch's entry), from which the kernel forms AB and AC with the same
subtractions while it stages them: no packing launch per call. Results are
``dst [R]`` float32 and the original triangle index ``idx [R]`` int32 (-1
on a miss or a dead lane). :func:`search_brute_split` models how the kernel
splits one ray's scan across lanes (:func:`brute_parts`).
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.scene.types import EPSILON, MISS_DST, Triangles
from raytracingc_tpu_torch.utils.profiling import COUNTS


def pack_rows(a, b, c, normal, n_live: int) -> torch.Tensor:
    """``[n_live, 12]`` rows of A, AB = B - A, AC = C - A, N (the kernel's
    triangle layout) from ``[T, 3]`` vertex and normal arrays."""
    a = a[:n_live]
    return torch.cat([a, b[:n_live] - a, c[:n_live] - a, normal[:n_live]],
                     dim=1).contiguous()


def pack_triangles(tris: Triangles, n_live: int) -> torch.Tensor:
    """:func:`pack_rows` of a scene's triangles."""
    return pack_rows(tris.a, tris.b, tris.c, tris.normal, n_live)


def mt_distance(ray, tri):
    """Möller–Trumbore distance, or ``MISS_DST`` where the test rejects.

    ``ray = (ox, oy, oz, dx, dy, dz)`` and ``tri = (ax, ay, az, abx, aby,
    abz, acx, acy, acz, nx, ny, nz)`` broadcast against each other. The op
    order is the TPU kernels' (``_mt_block_test``) and the CUDA kernels'
    (``csrc/mt.cuh``): backface cull on the stored normal, the
    ``|det| < EPSILON`` guard, IEEE division, each product and sum rounded
    on its own.
    """
    ox, oy, oz, dx, dy, dz = ray
    ax, ay, az, abx, aby, abz, acx, acy, acz, nx, ny, nz = tri
    dn = dx * nx + dy * ny + dz * nz  # backface cull
    hx = dy * acz - dz * acy
    hy = dz * acx - dx * acz
    hz = dx * acy - dy * acx
    det = abx * hx + aby * hy + abz * hz
    degenerate = det.abs() < EPSILON
    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    sx = ox - ax
    sy = oy - ay
    sz = oz - az
    u = (sx * hx + sy * hy + sz * hz) * inv_det
    qx = sy * abz - sz * aby
    qy = sz * abx - sx * abz
    qz = sx * aby - sy * abx
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    dst = (acx * qx + acy * qy + acz * qz) * inv_det
    valid = (
        (dn < 0.0) & ~degenerate & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
        & (u + v <= 1.0) & (dst >= EPSILON)
    )
    return torch.where(valid, dst, MISS_DST)


def search_brute_reference(o, d, tri, n_live, alive=None, chunk=256):
    """Plain PyTorch version of the kernel, op for op.

    Scans ``tri[:n_live]`` in chunks of ``chunk`` rows to bound memory. The
    first-minimum ``min`` inside a chunk plus a strict ``<`` across chunks
    gives the kernel's tie rule: the lowest index among equal distances.
    """
    r = o.shape[0]
    best_d = torch.full((r,), MISS_DST, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    ray = (o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3])
    for base in range(0, n_live, chunk):
        t = tri[base:min(base + chunk, n_live)]
        dst = mt_distance(ray, t.T)  # [R, C]
        dmin, j = dst.min(dim=1)  # first minimum
        better = dmin < best_d  # strict <: the earlier chunk keeps ties
        best_d = torch.where(better, dmin, best_d)
        best_i = torch.where(better, j.to(torch.int32) + base, best_i)
    if alive is not None:
        best_d = torch.where(alive, best_d, MISS_DST)
        best_i = torch.where(alive, best_i, -1)
    return best_d, best_i


# The kernel's split of each ray's scan (csrc/search_brute.cu): lanes per
# ray from the ray and triangle counts, at most MAX_PARTS, with at least
# MIN_PART_ROWS rows each; triangles staged TILE_ROWS at a time.
FILL_LANES = 132 * 2048
MAX_PARTS = 16
MIN_PART_ROWS = 16
TILE_ROWS = 1536


def brute_parts(n_rays: int, n_live: int) -> int:
    """Lanes per ray of the kernel (``brute_parts`` in the source): the
    smallest power of two S with ``n_rays * S >= FILL_LANES`` (about a
    card's worth of threads), at most :data:`MAX_PARTS`, with at least
    :data:`MIN_PART_ROWS` rows per part."""
    s = 1
    while s < MAX_PARTS and n_rays * s < FILL_LANES and n_live >= 2 * s * MIN_PART_ROWS:
        s *= 2
    return s


def search_brute_split(o, d, tri, n_live, alive=None, parts=None):
    """Plain model of the kernel's split: lane ``p`` of a ray scans
    triangles ``p, p + S, p + 2S, ...`` in ascending order with the strict
    ``<``, and the S results merge by a lex-min on ``(dst, idx)`` whose
    identity is ``(MISS_DST, -1)``. ``parts`` defaults to
    :func:`brute_parts`. Equal to :func:`search_brute_reference` bit for bit
    (the tests hold it so, ties across parts included)."""
    parts = brute_parts(o.shape[0], n_live) if parts is None else parts
    best_d = torch.full((o.shape[0],), MISS_DST, dtype=torch.float32, device=o.device)
    best_i = torch.full((o.shape[0],), -1, dtype=torch.int32, device=o.device)
    for p in range(parts):
        sub = tri[p:n_live:parts]
        dp, ip = search_brute_reference(o, d, sub, sub.shape[0])
        ip = torch.where(ip >= 0, ip * parts + p, -1)
        take = (dp < best_d) | ((dp == best_d) & (ip < best_i))
        best_d = torch.where(take, dp, best_d)
        best_i = torch.where(take, ip, best_i)
    if alive is not None:
        best_d = torch.where(alive, best_d, MISS_DST)
        best_i = torch.where(alive, best_i, -1)
    return best_d, best_i


def _check_rows(name, x, width, device):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != width:
        raise ValueError(
            f"{name}: expected float32 [N, {width}], got {x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, o on {device}")


def _check_args(o, d, tables, n_live, alive):
    """``tables``: ``(name, tensor, width)`` of the triangle inputs, whose
    rows must hold at least ``n_live`` triangles."""
    device = o.device
    _check_rows("o", o, 3, device)
    _check_rows("d", d, 3, device)
    for name, x, width in tables:
        _check_rows(name, x, width, device)
    if d.shape != o.shape:
        raise ValueError(f"d {tuple(d.shape)} != o {tuple(o.shape)}")
    rows = min(x.shape[0] for _, x, _ in tables)
    if not 0 <= n_live <= rows:
        raise ValueError(f"n_live={n_live} outside [0, {rows}]")
    if o.shape[0] >= 2**31:
        raise ValueError(f"{o.shape[0]} rays: the kernel indexes rays in int32")
    if alive is not None:
        if alive.dtype != torch.bool or alive.shape != o.shape[:1]:
            raise ValueError(
                f"alive: expected bool [{o.shape[0]}], got {alive.dtype} "
                f"{tuple(alive.shape)}"
            )
        if not alive.is_contiguous() or alive.device != device:
            raise ValueError("alive: expected a contiguous tensor on o's device")


def _launch(entry: str, o, d, alive, tables, n_live):
    """Launch ``entry`` (``rtc_search_brute`` or ``rtc_search_brute_tris``)
    on the current stream of ``o``'s card; count it in
    ``search_brute.launches``."""
    r = o.shape[0]
    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    alive_ptr = None if alive is None else alive.data_ptr()  # bool is 1 byte
    with _build.card(o.device) as (lib, stream):
        code = getattr(lib, entry)(o.data_ptr(), d.data_ptr(), alive_ptr,
                                   *(x.data_ptr() for x in tables), r, n_live,
                                   dst.data_ptr(), idx.data_ptr(), stream)
    _build.check(code, "search_brute launch")
    search_brute.launches += 1
    return dst, idx


def search_brute(o, d, tri, n_live, alive=None):
    """Closest hit of each ray among the first ``n_live`` triangles:
    ``(dst, idx)``.

    ``tri`` is either ``[T, 12]`` packed rows (:func:`pack_triangles`) or
    the scene's :class:`Triangles` themselves, the pack-free entry the
    search dispatch takes: the kernel reads ``a``, ``b``, ``c`` and
    ``normal`` (each made contiguous) and forms AB and AC while staging,
    so no packing runs per call, with the same bits as the packed rows.

    A CPU tensor runs :func:`search_brute_reference` (over
    :func:`pack_triangles` for the pack-free entry). A CUDA tensor launches
    the kernel (building it on first use) and counts the launch in
    ``search_brute.launches``; any other device raises. Dead lanes report
    ``(MISS_DST, -1)``. Either way the call adds its lanes times ``n_live``
    to the ``search.pairs`` counter (``utils/profiling.py``), dead lanes
    included.
    """
    COUNTS["search.pairs"] += o.shape[0] * n_live
    if isinstance(tri, Triangles):
        return _search_tris(o, d, *(x.contiguous() for x in (
            tri.a, tri.b, tri.c, tri.normal)), n_live, alive)
    return _search_rows(o, d, tri, n_live, alive)


@no_tangent
def _search_rows(o, d, tri, n_live, alive=None):
    """:func:`search_brute` over packed rows."""
    _check_args(o, d, (("tri", tri, 12),), n_live, alive)
    if o.device.type == "cpu":
        return search_brute_reference(o, d, tri, n_live, alive)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_brute: no kernel for device {o.device}")
    return _launch("rtc_search_brute", o, d, alive, (tri,), n_live)


@no_tangent
def _search_tris(o, d, a, b, c, normal, n_live, alive=None):
    """:func:`search_brute` over ``[T, 3]`` vertex and normal arrays, the
    kernel's pack-free entry (``rtc_search_brute_tris``)."""
    tables = (("a", a, 3), ("b", b, 3), ("c", c, 3), ("normal", normal, 3))
    _check_args(o, d, tables, n_live, alive)
    if o.device.type == "cpu":
        return search_brute_reference(o, d, pack_rows(a, b, c, normal, n_live),
                                      n_live, alive)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_brute: no kernel for device {o.device}")
    return _launch("rtc_search_brute_tris", o, d, alive, (a, b, c, normal), n_live)


search_brute.launches = 0
