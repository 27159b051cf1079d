"""Möller–Trumbore as bilinear forms (K8): the tensor-core kernel and its
plain version.

Counterpart of ``raytracingc_tpu/ops/intersect_mxu.py`` (``pack_coeffs_mxu``,
``_split_bf16``, ``_build_features``, ``_mxu_block_test`` and
``_search_kernel_mxu`` with its launcher). Every MT quantity of a ray and a
triangle is a dot product of 16 ray features ``[1, o, d, ox*dy, ox*dz,
oy*dx, oy*dz, oz*dx, oz*dy, 0, 0, 0]`` with 16 per-triangle coefficients:
``det``, ``dn`` (the backface term on the stored normal), ``u′``, ``v′`` and
``t′``. The epilogue is the brute kernel's: ``inv_det = 1 / (|det| < EPS ?
1 : det)``, ``u = u′ inv_det``, ``v``, ``dst = t′ inv_det``, the same
validity tests, and the lexicographic minimum of (dst, original index).

The kernel is ``csrc/search_mxu.cu``: the four comparison planes go through
bf16 tensor-core products; ``t′`` (the plane that cancels catastrophically)
and the original index stay on the CUDA cores. :func:`search_mxu_reference`
is its plain PyTorch version, used on CPU tensors and by the tests and
``chip_smoke.py`` to hold the kernel against. The two agree within a
contract, not bit for bit (the tensor cores' accumulation order is not
specified): see ``PERF.md``.

Precision (``RTC_MXU_PRECISION``, read by ``ops/search.py``):

* ``split3`` (default): coefficients and features split into a bf16 hi/lo
  pair (:func:`split_bf16`); each plane is ``ch·fh + ch·fl + cl·fh``.
  Hit/miss decisions within ~1e-4 of a barycentric edge can flip against
  the f32 search.
* ``highest``: the plain version is the f32 dot; the kernel approximates it
  with a three-way bf16 split and six products (see the kernel's note).

Culling is per 1,024-ray program: the union of its 128 packets' block words
(``ops/culling.py::program_union_words``). Dead lanes report ``(MISS_DST,
-1)``.
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.ops.accel import BLOCK, PAD_ORIG_IDX
from raytracingc_tpu_torch.ops.culling import RAYS_PER_PROGRAM
from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table, lex_merge
from raytracingc_tpu_torch.scene.types import EPSILON, MISS_DST, Triangles

N_QUANT = 6  # det, dn, u', v', t', original index
FEATS = 16  # 13 used + 3 zero columns
ROWS_PER_BLOCK = N_QUANT * BLOCK  # 768 table rows per 128-triangle block
# The largest padded triangle count of the JAX kernel's table (3 MiB of
# f32, one resident VMEM block); the port keeps the JAX gate.
MXU_MAX_TRIS = 8192
PRECISIONS = ("split3", "highest")
# Columns of the ray features that the planes use; columns 13-15 are zero in
# every table row, and the t′ row is zero past column 3.
_USED = 13
_T_USED = 4

# (program, block) pairs per step of the plain search: each pair makes
# [4, 128, 1024] float32 temporaries (2 MiB).
PAIR_CHUNK = 8


def _cross(x, y):
    return torch.stack([
        x[:, 1] * y[:, 2] - x[:, 2] * y[:, 1],
        x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2],
        x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0],
    ], dim=1)


def _mono(x):
    """``det3(o, d, X)`` coefficients on ``[oxdy, oxdz, oydx, oydz, ozdx, ozdy]``."""
    return torch.stack(
        [x[:, 2], -x[:, 1], -x[:, 2], x[:, 0], x[:, 1], -x[:, 0]], dim=1)


def pack_coeffs_mxu(tris: Triangles, orig_idx) -> torch.Tensor:
    """Per-triangle MT coefficient table → ``[6T, 16]`` float32, block-major.

    Rows ``[768 j, 768 (j + 1))`` belong to triangle block ``j``: 128 rows
    each of ``det``, ``dn``, ``u′``, ``v′``, ``t′`` and the original index
    (as float32, ``min(orig_idx, 2**30)``). The JAX package's layout, so the
    bridge carries its table as it is. Padding triangles (zero vertices)
    give zero rows: ``det = 0``, never valid.
    """
    a = tris.a
    ab = tris.b - a
    ac = tris.c - a
    ng = _cross(ab, ac)
    t = a.shape[0]
    if t % BLOCK:
        raise ValueError(f"{t} triangles: not a multiple of {BLOCK}")
    z1 = a.new_zeros((t, 1))
    z3 = a.new_zeros((t, 3))
    z6 = a.new_zeros((t, 6))

    def rows(c0, o3, d3, m6):
        return torch.cat([c0, o3, d3, m6, z3], dim=1)  # [T, 16]

    a_ng = (a[:, 0] * ng[:, 0] + a[:, 1] * ng[:, 1]) + a[:, 2] * ng[:, 2]
    oi = torch.clamp_max(orig_idx.to(torch.int64), PAD_ORIG_IDX)
    quant = torch.stack([
        rows(z1, z3, _cross(ac, ab), z6),  # det
        rows(z1, z3, tris.normal, z6),  # dn (the stored normal)
        rows(z1, z3, _cross(a, ac), _mono(ac)),  # u'
        rows(z1, z3, _cross(ab, a), -_mono(ab)),  # v'
        rows(-a_ng[:, None], ng, z3, z6),  # t'
        rows(oi.to(torch.float32)[:, None], z3, z3, z6),  # original index
    ])  # [6, T, 16]
    quant = quant.reshape(N_QUANT, t // BLOCK, BLOCK, FEATS)
    return quant.transpose(0, 1).reshape(t * N_QUANT, FEATS).contiguous()


def split_bf16(x):
    """``x ≈ hi + lo`` in bf16: ``hi`` the round-to-nearest-even bf16 of
    ``x``, ``lo`` that of the residual (both as bfloat16 tensors)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def build_features(o, d):
    """Rays ``[R, 3]`` → the ``[R, 16]`` float32 ray features, ray-major."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    return torch.stack([
        one, ox, oy, oz, dx, dy, dz,
        ox * dy, ox * dz, oy * dx, oy * dz, oz * dx, oz * dy,
        zero, zero, zero,
    ], dim=1)


def _fold(c, f, n):
    """``sum_k c[..., k] * f[..., k]`` over ``k < n`` in ascending order,
    each product and sum rounded on its own (float32; broadcasting)."""
    acc = c[..., 0] * f[..., 0]
    for k in range(1, n):
        acc = acc + c[..., k] * f[..., k]
    return acc


def _planes(c, f, precision: str):
    """The four comparison planes of coefficient rows ``c [n, 4, 128, 1, 16]``
    against features ``f [n, 1, 1, RP, 16]``: ``[n, 4, 128, RP]``."""
    if precision == "highest":
        return _fold(c, f, _USED)
    ch, cl = (x.to(torch.float32) for x in split_bf16(c))
    fh, fl = (x.to(torch.float32) for x in split_bf16(f))
    return (_fold(ch, fh, _USED) + _fold(ch, fl, _USED)) + _fold(cl, fh, _USED)


def search_mxu_reference(o, d, words, flags, coeffs, orig_idx,
                         precision: str = "split3", alive=None,
                         chunk=PAIR_CHUNK):
    """Plain PyTorch version of the kernel (same inputs, same contract).

    Program ``g`` (rays ``1024 g .. 1024 g + 1023``) tests the blocks of its
    union ``words[g]`` when ``flags[g] != 0``. Each plane is a fixed-order
    float32 sum over the features (``highest``), or the sum of the three
    bf16 pass products, each exact in float32 (``split3``), so a lane's
    result does not depend on the batch. ``t′`` is ``((c0 + c1 ox) + c2 oy)
    + c3 oz`` in both modes, as in the kernel; the original index comes from
    ``orig_idx``.
    """
    r = o.shape[0]
    dev = o.device
    g = words.shape[0]
    n_blocks = orig_idx.shape[0] // BLOCK
    feats = torch.nn.functional.pad(build_features(o, d),
                                    (0, 0, 0, g * RAYS_PER_PROGRAM - r))
    feats = feats.reshape(g, RAYS_PER_PROGRAM, FEATS)
    table = bitmask_table(words, n_blocks) & (flags != 0)[:, None]
    coef = coeffs.reshape(n_blocks, N_QUANT, BLOCK, FEATS)
    oi_blk = orig_idx.reshape(n_blocks, BLOCK)
    best_d = torch.full((g * RAYS_PER_PROGRAM,), MISS_DST, dtype=torch.float32,
                        device=dev)
    best_i = torch.full_like(best_d, PAD_ORIG_IDX, dtype=torch.int32)
    big = torch.full((), PAD_ORIG_IDX, dtype=torch.int32, device=dev)
    lanes = torch.arange(RAYS_PER_PROGRAM, device=dev)
    pg, blk = torch.nonzero(table, as_tuple=True)
    for s in range(0, pg.numel(), chunk):
        p, b = pg[s:s + chunk], blk[s:s + chunk]
        f = feats[p][:, None, None]  # [n, 1, 1, 1024, 16]
        c = coef[b]  # [n, 6, 128, 16]
        det, dn, up, vp = _planes(c[:, :4, :, None], f, precision).unbind(1)
        tp = _fold(c[:, 4, :, None], f[:, 0], _T_USED)  # [n, 128, 1024]
        degenerate = det.abs() < EPSILON
        inv_det = 1.0 / torch.where(degenerate, 1.0, det)
        u = up * inv_det
        v = vp * inv_det
        dst = tp * inv_det
        valid = ((dn < 0.0) & ~degenerate & (u >= 0.0) & (u <= 1.0)
                 & (v >= 0.0) & (u + v <= 1.0) & (dst >= EPSILON))
        dstm = torch.where(valid, dst, MISS_DST)
        oi = torch.where(valid, oi_blk[b][:, :, None], big)
        dmin = dstm.amin(dim=1)  # [n, 1024]
        imin = torch.where(dstm == dmin[:, None], oi, big).amin(dim=1)
        rid = (p[:, None] * RAYS_PER_PROGRAM + lanes).reshape(-1)
        best_d, best_i = lex_merge(best_d, best_i, rid, dmin.reshape(-1),
                                   imin.reshape(-1), big)
    best_d, best_i = best_d[:r], best_i[:r]
    best_i = torch.where(best_d < MISS_DST, best_i, -1)
    if alive is not None:
        best_d = torch.where(alive, best_d, MISS_DST)
        best_i = torch.where(alive, best_i, -1)
    return best_d, best_i


def _check_args(o, d, words, flags, coeffs, orig_idx, precision, alive):
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{', '.join(PRECISIONS)}")
    t = orig_idx.shape[0] if orig_idx.dim() == 1 else -1
    g = -(-o.shape[0] // RAYS_PER_PROGRAM)
    want = [
        ("o", o, torch.float32, (o.shape[0], 3)),
        ("d", d, torch.float32, (o.shape[0], 3)),
        ("words", words, torch.int32, (g, words.shape[-1])),
        ("flags", flags, torch.int32, (g,)),
        ("coeffs", coeffs, torch.float32, (t // BLOCK * ROWS_PER_BLOCK, FEATS)),
        ("orig_idx", orig_idx, torch.int32, (t,)),
    ]
    if alive is not None:
        want.append(("alive", alive, torch.bool, (o.shape[0],)))
    for name, x, dtype, shape in want:
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
    if t <= 0 or t % BLOCK:
        raise ValueError(f"orig_idx: {t} triangles, not a positive multiple "
                         f"of {BLOCK}")
    if o.shape[0] >= 2**31 - RAYS_PER_PROGRAM:
        raise ValueError(f"{o.shape[0]} rays: the kernel indexes rays in int32")


def search_mxu(o, d, words, flags, coeffs, orig_idx, precision: str = "split3",
               alive=None):
    """Closest hit by bilinear MT over each program's union: ``(dst [R], idx
    [R])``, ``idx`` in original order, -1 on a miss or a dead lane.

    ``words [G, W]`` and ``flags [G]`` int32 from
    ``culling.program_union_words`` (``G = ceil(R / 1024)``), ``coeffs``
    the ``[6T, 16]`` table of :func:`pack_coeffs_mxu` and ``orig_idx [T]``
    of the same (permuted) triangles. A CPU tensor runs
    :func:`search_mxu_reference`. A CUDA tensor launches
    ``csrc/search_mxu.cu`` (building the library on first use) and counts
    the launch in ``search_mxu.launches``; any other device raises.
    """
    _check_args(o, d, words, flags, coeffs, orig_idx, precision, alive)
    if o.device.type == "cpu":
        return search_mxu_reference(o, d, words, flags, coeffs, orig_idx,
                                    precision, alive)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_mxu: no kernel for device {o.device}")

    import ctypes

    from raytracingc_tpu_torch.ops import _build

    lib = _build.load_library()
    r = o.shape[0]
    dst = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    alive_ptr = None if alive is None else alive.data_ptr()  # bool is 1 byte
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        code = lib.rtc_search_mxu(
            o.data_ptr(), d.data_ptr(), alive_ptr, words.data_ptr(),
            flags.data_ptr(), coeffs.data_ptr(), orig_idx.data_ptr(),
            ctypes.c_int(r), ctypes.c_int(words.shape[1]),
            ctypes.c_int(orig_idx.shape[0] // BLOCK),
            ctypes.c_int(PRECISIONS.index(precision)),
            dst.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(code, "search_mxu launch")
    search_mxu.launches += 1
    return dst, idx


search_mxu.launches = 0
