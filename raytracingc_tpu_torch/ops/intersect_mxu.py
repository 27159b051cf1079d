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
bf16 ``mma.sync`` products; ``t′`` (the plane that cancels catastrophically)
and the original index stay on the CUDA cores. :func:`search_mxu_reference`
is its plain PyTorch version, used on CPU tensors and by the tests and
``chip_smoke.py`` to hold the kernel against. The two agree within a
contract, not bit for bit (the tensor cores' accumulation order is not
specified): see ``PERF.md``. On an H100 the bound is the FP32 epilogue (21
operations per tested pair against 144 or 288 tensor FLOPs).

The kernel's design, and the plain model of each piece:

* a pack kernel splits the four planes into bf16 parts once per call, into
  a scratch table in the ``mma.sync`` A-fragment order
  (:func:`mxu_fragments`, :data:`FRAG_BYTES` per block and part), which the
  search reads with one 16-byte load per lane and no shared memory;
* work items of (program, :data:`SLICE` rays, a run of at most
  :data:`SPLIT` union blocks), counted per program by a count kernel
  (:func:`mxu_items`; :func:`mxu_item` is one item's slice and blocks),
  claimed by persistent warps and merged through the 64-bit keys of the
  range and words kernels (:func:`search_mxu_split` is the item walk with
  that merge); the count kernel writes the scan of the counts itself, and
  the CUDA unpack applies the dead-lane rule.

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

from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.ops.accel import BLOCK, PAD_ORIG_IDX
from raytracingc_tpu_torch.ops.culling import BITS_PER_WORD, RAYS_PER_PROGRAM
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table, lex_merge
from raytracingc_tpu_torch.ops.search_range import MISS_KEY, pack_keys, unpack_keys
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
# The kernel's work items (csrc/search_mxu.cu): kSlice rays of one program
# against a run of at most kSplit of its union blocks.
SLICE = 32
SPLIT = 4
# The fragment table: planes det, dn, u', v' in tiles of 16 triangles, each
# part of a (block, plane) 8 x 32 lanes x 16 bytes.
FRAG_PLANES = 4
TRI_TILES = BLOCK // 16
FRAG_BYTES = FRAG_PLANES * TRI_TILES * 32 * 16  # per block and part


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
    hi, lo = split_parts(x, 2)
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


def split_parts(x, parts: int):
    """``x`` as ``parts`` bf16 tensors, each the round-to-nearest-even bf16
    of what the earlier parts leave (:func:`split_bf16` at 2 parts; the
    kernel's ``split<kParts>``)."""
    out = []
    for _ in range(parts):
        h = x.to(torch.bfloat16)
        out.append(h)
        x = x - h.to(torch.float32)
    return out


def mxu_fragments(coeffs, parts: int):
    """Plain version of ``csrc/search_mxu.cu::mxu_pack_kernel``: the four
    comparison planes of the ``[6T, 16]`` table split into ``parts`` bf16
    parts (:func:`split_parts`), in the ``mma.sync`` m16n8k16 A-fragment
    order, as int16 bit patterns ``[n_blocks, 4, parts, 8, 32, 8]``: block,
    plane (det, dn, u′, v′), part, tile of 16 triangles, lane ``l = 4 g +
    t`` and half ``i`` of its four 32-bit registers, which holds row ``16
    tile + g + 8 ((i >> 1) & 1)`` and column ``2 t + (i & 1) + 8 (i >> 2)``
    of the plane. Its bytes are the kernel's scratch table."""
    n_blocks = coeffs.shape[0] // ROWS_PER_BLOCK
    planes = coeffs.reshape(n_blocks, N_QUANT, BLOCK, FEATS)[:, :FRAG_PLANES]
    bits = torch.stack([x.view(torch.int16) for x in split_parts(planes, parts)], 2)
    dev = coeffs.device
    tile = torch.arange(TRI_TILES, device=dev)[:, None, None]
    lane = torch.arange(32, device=dev)[None, :, None]
    i = torch.arange(8, device=dev)[None, None, :]
    row = 16 * tile + lane // 4 + 8 * ((i >> 1) & 1)
    col = 2 * (lane % 4) + (i & 1) + 8 * (i >> 2)
    return bits[:, :, :, row, col]


def union_blocks(words, n_blocks: int):
    """``[G]`` int64: the blocks of each program's union (bits past
    ``n_blocks`` and bit 31 of each word count for nothing)."""
    return bitmask_table(words, n_blocks).sum(1)


def mxu_items(words, flags, n_rays: int, n_blocks: int, split: int = SPLIT,
              slice_: int = SLICE):
    """Work items per program, ``[G]`` int32: ``ceil(rays / slice_)`` ray
    slices times ``ceil(union blocks / split)`` runs, 0 where the flag is 0.
    The plain version of ``csrc/search_mxu.cu::mxu_items_kernel``."""
    g = words.shape[0]
    rays = (n_rays - RAYS_PER_PROGRAM * torch.arange(g, device=words.device)).clamp(
        max=RAYS_PER_PROGRAM)
    runs = -(-union_blocks(words, n_blocks) // split)
    return torch.where(flags != 0, -(-rays // slice_) * runs, 0).to(torch.int32)


def mxu_item(row, rays: int, n_blocks: int, split: int, slice_: int,
             k: int) -> tuple[int, list[int]]:
    """Work item ``k`` of one program whose union words are ``row`` (an int
    list) and which holds ``rays`` rays: ``(ray slice, blocks)``, step by
    step as the kernel finds them. Run ``k // slices`` for slice ``k %
    slices``; the run's first block is reached by skipping ``split * run``
    set bits, whole words by popcount, and the run walks at most ``split``
    blocks in ascending order."""
    slices = -(-rays // slice_)

    def word(w):
        n = min(max(n_blocks - w * BITS_PER_WORD, 0), BITS_PER_WORD)
        return (row[w] & 0xFFFFFFFF) & ((1 << n) - 1)

    skip, w = (k // slices) * split, 0
    bits = word(0)
    while skip >= bits.bit_count():
        skip -= bits.bit_count()
        w += 1
        bits = word(w)
    for _ in range(skip):
        bits &= bits - 1
    out = []
    while len(out) < split:
        while bits == 0 and w + 1 < len(row):
            w += 1
            bits = word(w)
        if bits == 0:
            break
        out.append(w * BITS_PER_WORD + (bits & -bits).bit_length() - 1)
        bits &= bits - 1
    return k % slices, out


def _program_search(feats, table, coeffs, orig_idx, precision: str, chunk):
    """The lex-min of (dst, original index) of grouped rays: ray ``n`` of
    ``feats [G, N, 16]`` over the blocks ``b`` of its group ``g`` with
    ``table[g, b]``. Returns ``(best_d, best_i)
    [G * N]``, ``(MISS_DST, 2**30)`` where nothing is valid."""
    g, n = feats.shape[:2]
    dev = feats.device
    n_blocks = orig_idx.shape[0] // BLOCK
    coef = coeffs.reshape(n_blocks, N_QUANT, BLOCK, FEATS)
    oi_blk = orig_idx.reshape(n_blocks, BLOCK)
    best_d = torch.full((g * n,), MISS_DST, dtype=torch.float32, device=dev)
    best_i = torch.full_like(best_d, PAD_ORIG_IDX, dtype=torch.int32)
    big = torch.full((), PAD_ORIG_IDX, dtype=torch.int32, device=dev)
    lanes = torch.arange(n, device=dev)
    pg, blk = torch.nonzero(table, as_tuple=True)
    for s in range(0, pg.numel(), chunk):
        p, b = pg[s:s + chunk], blk[s:s + chunk]
        f = feats[p][:, None, None]  # [n, 1, 1, N, 16]
        c = coef[b]  # [n, 6, 128, 16]
        det, dn, up, vp = _planes(c[:, :4, :, None], f, precision).unbind(1)
        tp = _fold(c[:, 4, :, None], f[:, 0], _T_USED)  # [n, 128, N]
        degenerate = det.abs() < EPSILON
        inv_det = 1.0 / torch.where(degenerate, 1.0, det)
        u = up * inv_det
        v = vp * inv_det
        dst = tp * inv_det
        valid = ((dn < 0.0) & ~degenerate & (u >= 0.0) & (u <= 1.0)
                 & (v >= 0.0) & (u + v <= 1.0) & (dst >= EPSILON))
        dstm = torch.where(valid, dst, MISS_DST)
        oi = torch.where(valid, oi_blk[b][:, :, None], big)
        dmin = dstm.amin(dim=1)  # [n, N]
        imin = torch.where(dstm == dmin[:, None], oi, big).amin(dim=1)
        rid = (p[:, None] * n + lanes).reshape(-1)
        best_d, best_i = lex_merge(best_d, best_i, rid, dmin.reshape(-1),
                                   imin.reshape(-1), big)
    return best_d, best_i


def _program_features(o, d, g: int):
    """Rays ``[R, 3]`` padded to ``g`` programs: features ``[g, 1024, 16]``."""
    feats = torch.nn.functional.pad(build_features(o, d),
                                    (0, 0, 0, g * RAYS_PER_PROGRAM - o.shape[0]))
    return feats.reshape(g, RAYS_PER_PROGRAM, FEATS)


def _finish(best_d, best_i, r: int, alive):
    best_d, best_i = best_d[:r], best_i[:r]
    best_i = torch.where(best_d < MISS_DST, best_i, -1)
    if alive is not None:
        best_d = torch.where(alive, best_d, MISS_DST)
        best_i = torch.where(alive, best_i, -1)
    return best_d, best_i


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
    g = words.shape[0]
    n_blocks = orig_idx.shape[0] // BLOCK
    table = bitmask_table(words, n_blocks) & (flags != 0)[:, None]
    best = _program_search(_program_features(o, d, g), table, coeffs, orig_idx,
                           precision, chunk)
    return _finish(*best, o.shape[0], alive)


def search_mxu_split(o, d, words, flags, coeffs, orig_idx,
                     precision: str = "split3", alive=None, split: int = SPLIT,
                     slice_: int = SLICE, chunk=PAIR_CHUNK):
    """Plain model of the kernel's item walk: for every work item (program,
    ray slice, run of ``split`` union blocks, :func:`mxu_item`) the lex-min
    of the slice's rays over the run's blocks, the items of a ray merged
    only through :func:`~raytracingc_tpu_torch.ops.search_range.pack_keys`
    by a minimum, from :data:`MISS_KEY`, then unpacked with the dead-lane
    rule."""
    r = o.shape[0]
    g = words.shape[0]
    n_blocks = orig_idx.shape[0] // BLOCK
    feats = _program_features(o, d, g).reshape(-1, slice_, FEATS)
    items = mxu_items(words, flags, r, n_blocks, split, slice_).tolist()
    rows = words.tolist()
    slices = RAYS_PER_PROGRAM // slice_
    keys = torch.full((g * RAYS_PER_PROGRAM,), MISS_KEY, dtype=torch.int64,
                      device=o.device)
    for k in range(max(items, default=0)):
        # Item k of every program: its slice's rays against its run's blocks.
        table = torch.zeros((g * slices, n_blocks), dtype=torch.bool)
        for p in range(g):
            if k < items[p]:
                s, blocks = mxu_item(rows[p], min(r - RAYS_PER_PROGRAM * p,
                                                  RAYS_PER_PROGRAM),
                                     n_blocks, split, slice_, k)
                table[p * slices + s, blocks] = True
        dk, ik = _program_search(feats, table.to(o.device), coeffs, orig_idx,
                                 precision, chunk)
        keys = torch.minimum(keys, torch.where(dk < MISS_DST, pack_keys(dk, ik),
                                               MISS_KEY))
    return _finish(*unpack_keys(keys), r, alive)


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


@no_tangent
def search_mxu(o, d, words, flags, coeffs, orig_idx, precision: str = "split3",
               alive=None):
    """Closest hit by bilinear MT over each program's union: ``(dst [R], idx
    [R])``, ``idx`` in original order, -1 on a miss or a dead lane.

    ``words [G, W]`` and ``flags [G]`` int32 from
    ``culling.program_union_words`` (``G = ceil(R / 1024)``), ``coeffs``
    the ``[6T, 16]`` table of :func:`pack_coeffs_mxu` and ``orig_idx [T]``
    of the same (permuted) triangles. A CPU tensor runs
    :func:`search_mxu_reference`. A CUDA tensor launches
    ``csrc/search_mxu.cu`` (building the library on first use) through one
    C call, which launches the pack kernel into a scratch fragment table,
    the count kernel (it also scans the counts), the search and the CUDA
    unpack of the range kernel's source; it counts one launch per call in
    ``search_mxu.launches``. Any other device raises.
    """
    _check_args(o, d, words, flags, coeffs, orig_idx, precision, alive)
    if o.device.type == "cpu":
        return search_mxu_reference(o, d, words, flags, coeffs, orig_idx,
                                    precision, alive)
    if o.device.type != "cuda":
        raise RuntimeError(f"search_mxu: no kernel for device {o.device}")

    if coeffs.data_ptr() % 16:
        raise ValueError("coeffs: the kernel reads t′ rows as float4, expected "
                         "a 16-byte aligned tensor")

    r = o.shape[0]
    n_blocks = orig_idx.shape[0] // BLOCK
    prec = PRECISIONS.index(precision)
    # The fragment table, then ends [G], the claim counter and the keys [R]
    # (int64), in one allocation; dst and idx share the output's.
    scratch = torch.empty((n_blocks * (prec + 2) * FRAG_BYTES
                           + 8 * (words.shape[0] + 1 + r),), dtype=torch.uint8,
                          device=o.device)
    out = torch.empty((2, r), dtype=torch.int32, device=o.device)
    with _build.card(o.device) as (lib, stream):
        code = lib.rtc_search_mxu(
            o.data_ptr(), d.data_ptr(), None if alive is None else alive.data_ptr(),
            words.data_ptr(), flags.data_ptr(), coeffs.data_ptr(),
            orig_idx.data_ptr(), r, words.shape[1], n_blocks, prec,
            scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), stream)
    _build.check(code, "search_mxu launch")
    search_mxu.launches += 1
    return out[0].view(torch.float32), out[1]


def mxu_pack_cuda(coeffs, precision: str):
    """The CUDA pack kernel's fragment table of CUDA ``coeffs``, as
    :func:`mxu_fragments` shapes it (one launch; chip_smoke.py holds it to
    :func:`mxu_fragments` bit for bit)."""
    n_blocks = coeffs.shape[0] // ROWS_PER_BLOCK
    parts = PRECISIONS.index(precision) + 2
    frags = torch.empty((n_blocks * parts * FRAG_BYTES,), dtype=torch.uint8,
                        device=coeffs.device)
    with _build.card(coeffs.device) as (lib, stream):
        _build.check(lib.rtc_mxu_pack(coeffs.data_ptr(), n_blocks, parts - 2,
                                      frags.data_ptr(), stream), "mxu_pack launch")
    return frags.view(torch.int16).reshape(n_blocks, FRAG_PLANES, parts,
                                           TRI_TILES, 32, 8)


def search_mxu_grid(device, precision: str) -> tuple[int, int]:
    """``(resident CTAs per SM, SMs)`` of the search's persistent grid at
    ``precision`` on a CUDA ``device``."""
    import ctypes

    ctas, sms = ctypes.c_int(), ctypes.c_int()
    with _build.card(device) as (lib, _):
        _build.check(lib.rtc_search_mxu_grid(
            PRECISIONS.index(precision), ctypes.byref(ctas), ctypes.byref(sms)),
            "search_mxu grid")
    return ctas.value, sms.value


search_mxu.launches = 0
