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
the JAX launcher builds them. Results are ``dst [R]`` float32 and the
original triangle index ``idx [R]`` int32 (-1 on a miss or a dead lane).
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.scene.types import EPSILON, MISS_DST, Triangles


def pack_triangles(tris: Triangles, n_live: int) -> torch.Tensor:
    """``[n_live, 12]`` rows of A, AB, AC, N (the kernel's triangle layout)."""
    a = tris.a[:n_live]
    return torch.cat(
        [a, tris.b[:n_live] - a, tris.c[:n_live] - a, tris.normal[:n_live]],
        dim=1,
    ).contiguous()


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


def _check_args(o, d, tri, n_live, alive):
    for name, x, width in (("o", o, 3), ("d", d, 3), ("tri", tri, 12)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != width:
            raise ValueError(
                f"{name}: expected float32 [N, {width}], got {x.dtype} "
                f"{tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
    if d.shape != o.shape:
        raise ValueError(f"d {tuple(d.shape)} != o {tuple(o.shape)}")
    if not 0 <= n_live <= tri.shape[0]:
        raise ValueError(f"n_live={n_live} outside [0, {tri.shape[0]}]")
    if o.shape[0] >= 2**31:
        raise ValueError(f"{o.shape[0]} rays: the kernel indexes rays in int32")
    if alive is not None:
        if alive.dtype != torch.bool or alive.shape != o.shape[:1]:
            raise ValueError(
                f"alive: expected bool [{o.shape[0]}], got {alive.dtype} "
                f"{tuple(alive.shape)}"
            )
        if not alive.is_contiguous() or alive.device != o.device:
            raise ValueError("alive: expected a contiguous tensor on o's device")


@no_tangent
def search_brute(o, d, tri, n_live, alive=None):
    """Closest hit of each ray among ``tri[:n_live]``: ``(dst, idx)``.

    A CPU tensor runs :func:`search_brute_reference`. A CUDA tensor launches
    the kernel (building it on first use) and counts the launch in
    ``search_brute.launches``; any other device raises. Dead lanes report
    ``(MISS_DST, -1)``.
    """
    _check_args(o, d, tri, n_live, alive)
    if o.device.type == "cpu":
        return search_brute_reference(o, d, tri, n_live, alive)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_brute: no kernel for device {o.device}")

    import ctypes

    from raytracingc_tpu_torch.ops import _build

    lib = _build.load_library()
    r = o.shape[0]
    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    alive_ptr = None if alive is None else alive.data_ptr()  # bool is 1 byte
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        code = lib.rtc_search_brute(
            o.data_ptr(), d.data_ptr(), alive_ptr, tri.data_ptr(),
            ctypes.c_int(r), ctypes.c_int(n_live),
            dst.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(code, "search_brute launch")
    search_brute.launches += 1
    return dst, idx


search_brute.launches = 0
