"""Port parity: the block-AABB accel and the culling preludes.

``build_accel``, ``trivial_accel``, the slab-test words of the bitmask and
packed kernels and the culling granule are integer (or copied float) results
of the same numpy or elementwise op sequences in both packages, so they must
be EQUAL bit for bit. The one exception is the MXU coefficient table
``mxu_coeffs``: XLA:CPU contracts its cross products into FMA and the port
does not (ROADMAP Queue 3 P1), so each table is held bit for bit to its own
arithmetic, recomputed in numpy, and the two tables to each other within a
few ulps of each entry's largest product term
(:func:`assert_mxu_table_matches`).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu.ops.accel import trivial_accel as j_trivial_accel
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.ops import culling
from raytracingc_tpu_torch.ops.accel import build_accel, trivial_accel
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.scene.types import Triangles

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")


def soup(n, seed=0):
    """Small random triangles in a 6-unit cube (JAX ``Triangles``, live count)."""
    rs = np.random.default_rng(seed)
    a = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    b = a + rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    c = a + rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    nrm = np.cross(b - a, c - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    return jb.triangles_from_arrays(
        np.stack([a, b, c], 1), nrm.astype(np.float32),
        np.full((n, 3), 0.5, np.float32), np.zeros(n, np.float32),
        np.zeros(n, np.float32))


def port_tris(jtris):
    return Triangles(**{f: torch.from_numpy(np.array(getattr(jtris, f)))
                        for f in bridge.TRIANGLE_FIELDS})


def _fma(a, b, c):
    """float32 fma(a, b, c), exact in float64 before the one rounding."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _cross(x, y, contract):
    """``x × y`` in float32, each component ``x1 y2 - x2 y1`` rounded term
    by term, or as XLA:CPU contracts it: ``fma(x1, y2, -(x2 y1))``."""
    i, j = [1, 2, 0], [2, 0, 1]
    if contract:
        return _fma(x[:, i], y[:, j], -(x[:, j] * y[:, i]))
    return x[:, i] * y[:, j] - x[:, j] * y[:, i]


def mxu_table_numpy(a, b, c, normal, orig_idx, contract: bool):
    """``pack_coeffs_mxu`` in numpy float32, without contraction (the
    port's arithmetic) or with XLA:CPU's (its cross products as fmas; the
    sums stay term by term)."""
    ab, ac = b - a, c - a
    ng = _cross(ab, ac, contract)
    t = a.shape[0]
    z = lambda k: np.zeros((t, k), np.float32)
    rows = lambda c0, o3, d3, m6: np.concatenate([c0, o3, d3, m6, z(3)], 1)
    mono = lambda x: np.stack(
        [x[:, 2], -x[:, 1], -x[:, 2], x[:, 0], x[:, 1], -x[:, 0]], 1)
    a_ng = (a[:, 0] * ng[:, 0] + a[:, 1] * ng[:, 1]) + a[:, 2] * ng[:, 2]
    quant = np.stack([
        rows(z(1), z(3), _cross(ac, ab, contract), z(6)),
        rows(z(1), z(3), normal, z(6)),
        rows(z(1), z(3), _cross(a, ac, contract), mono(ac)),
        rows(z(1), z(3), _cross(ab, a, contract), -mono(ab)),
        rows(-a_ng[:, None], ng, z(3), z(6)),
        rows(np.minimum(orig_idx, 2**30).astype(np.float32)[:, None],
             z(3), z(3), z(6)),
    ])
    return quant.reshape(6, t // 128, 128, 16).transpose(1, 0, 2, 3).reshape(-1, 16)


def mxu_term_scale(a, b, c, normal):
    """For each entry of ``pack_coeffs_mxu``'s table, the magnitude of the
    largest product term that it sums (float64): ``max(|x1 y2|, |x2 y1|)``
    for a cross-product component, ``max_i |a_i| N_i`` for ``a . ng`` (N_i
    the scale of ``ng_i``), the entry itself where it is copied."""
    a, b, c, normal = (x.astype(np.float64) for x in (a, b, c, normal))
    ab, ac = b - a, c - a
    i, j = [1, 2, 0], [2, 0, 1]
    cross = lambda x, y: np.maximum(np.abs(x[:, i] * y[:, j]),
                                    np.abs(x[:, j] * y[:, i]))
    t = a.shape[0]
    z = lambda k: np.zeros((t, k))
    rows = lambda c0, o3, d3, m6: np.concatenate([c0, o3, d3, m6, z(3)], 1)
    mono = lambda x: np.abs(x[:, [2, 1, 2, 0, 1, 0]])
    ng = cross(ab, ac)
    quant = np.stack([
        rows(z(1), z(3), cross(ac, ab), z(6)),
        rows(z(1), z(3), np.abs(normal), z(6)),
        rows(z(1), z(3), cross(a, ac), mono(ac)),
        rows(z(1), z(3), cross(ab, a), mono(ab)),
        rows((np.abs(a) * ng).max(1)[:, None], ng, z(3), z(6)),
        rows(z(1), z(3), z(3), z(6)),
    ])
    return quant.reshape(6, t // 128, 128, 16).transpose(1, 0, 2, 3).reshape(-1, 16)


# The port's and JAX's tables, in ulps of each entry's largest product term:
# a cross-product component differs by one rounding of a product and the
# two final roundings (<= 2.5; 2 seen), a . ng by the three ng components'
# gaps times |a_i| and the sums' roundings (<= 16; 6 seen).
MXU_TABLE_ULPS = 3
MXU_TABLE_ULPS_T0 = 16


def assert_mxu_table_matches(port_table, jax_accel):
    """The port's table is its arithmetic bit for bit, JAX's is XLA's
    contracted arithmetic bit for bit: the two differ only by the FMA, by a
    few ulps of each entry's largest product term."""
    tri = jax_accel.triangles
    args = [np.asarray(x) for x in (tri.a, tri.b, tri.c, tri.normal,
                                    jax_accel.orig_idx)]
    jax_table = np.asarray(jax_accel.mxu_coeffs)
    for table, contract in ((port_table, False), (jax_table, True)):
        np.testing.assert_array_equal(
            np.asarray(table).view(np.int32),
            mxu_table_numpy(*args, contract).view(np.int32))
    gap = np.abs(np.asarray(port_table, np.float64) - jax_table)
    ulp = np.spacing(mxu_term_scale(*args[:4]).astype(np.float32)).astype(np.float64)
    limit = np.full((gap.shape[0] // 128, 128, 16), float(MXU_TABLE_ULPS))
    limit[4::6, :, 0] = MXU_TABLE_ULPS_T0  # the t' row's constant, -a . ng
    assert (gap <= limit.reshape(gap.shape) * ulp).all(), (
        f"port vs JAX table: {float((gap / ulp).max())} ulps of the largest term")


def assert_accels_equal(port, jax_accel):
    want = bridge.accel_arrays(jax_accel)
    for f in bridge.TRIANGLE_FIELDS:
        np.testing.assert_array_equal(getattr(port.triangles, f).numpy(),
                                      want["triangles"][f], err_msg=f)
    for f in bridge.ACCEL_FIELDS:
        got = getattr(port, f)
        if want[f] is None:
            assert got is None, f
            continue
        assert got.numpy().dtype == want[f].dtype, f
        if f == "mxu_coeffs" and not np.array_equal(got.numpy(), want[f]):
            assert_mxu_table_matches(got.numpy(), jax_accel)
            continue
        np.testing.assert_array_equal(got.numpy(), want[f], err_msg=f)


def rays(r, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-5, 5, (r, 3)).astype(np.float32)
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::97, 0] = 0.0  # axis-parallel directions take the 1e-20 substitution
    alive = rs.uniform(size=r) >= 0.3
    return o, d, alive


def box_x4():
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    return jb.tessellate(js.triangles, js.n_triangles, levels=4)


@pytest.mark.parametrize("case", ["soup700", "box_x4"])
def test_build_accel_matches_jax(case):
    jtris, n = soup(700, seed=5) if case == "soup700" else box_x4()
    ja = j_build_accel(jtris, n)
    pa = build_accel(port_tris(jtris), n)
    assert_accels_equal(pa, ja)
    t = jtris.a.shape[0]
    assert pa.n_blocks == t // 128 and pa.mxu_coeffs.shape == (6 * t, 16)
    assert_mxu_table_matches(pa.mxu_coeffs.numpy(), ja)
    # The inverse permutation really inverts orig_idx on live slots.
    live = pa.orig_idx[:n].long()
    assert torch.equal(pa.perm_of_orig[live], torch.arange(n, dtype=torch.int32))
    assert (pa.orig_idx[n:] == 2**30).all()
    # The bridge carries the JAX accel into the same port accel.
    assert_accels_equal(bridge.accel_from_numpy(bridge.accel_arrays(ja)), ja)


def test_trivial_accel_matches_jax():
    jtris, _ = soup(300, seed=2)
    assert_accels_equal(trivial_accel(port_tris(jtris)), j_trivial_accel(jtris))


def test_accel_moves_and_follows_triangles():
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    assert ts.accel is not None and ts.accel.n_blocks == 1
    moved = ts.to("meta")
    assert moved.accel.orig_idx.device.type == "meta"
    assert moved.accel.packed_plane.device.type == "meta"
    assert moved.accel.mxu_coeffs.device.type == "meta"
    tt, n = tb.tessellate(ts.triangles, ts.n_triangles, levels=2)
    dropped = ts.with_triangles(tt)
    assert dropped.accel is None and dropped.n_triangles == tt.count
    rebuilt = ts.with_triangles(tt, rebuild_accel=True)
    assert rebuilt.accel.orig_idx.shape[0] == tt.count
    with pytest.raises(ValueError, match="accel covers"):
        type(ts)(triangles=tt, spheres=ts.spheres, env=ts.env, n_triangles=n,
                 n_spheres=ts.n_spheres, accel=ts.accel)


def _jax_packets(o, d, alive):
    """The JAX launcher's packing: pad to whole packets, zero rays, dead."""
    r = o.shape[0]
    pad = -r % 8
    o_p = np.pad(o, ((0, pad), (0, 0))).reshape(-1, 8, 3)
    d_p = np.pad(d, ((0, pad), (0, 0))).reshape(-1, 8, 3)
    a_p = np.pad(alive, (0, pad)).reshape(-1, 8)
    return o_p, d_p, a_p


@pytest.mark.parametrize("with_alive", [False, True])
def test_packet_block_masks_match_jax(with_alive):
    jtris, n = soup(2000, seed=11)  # 16 blocks: one word
    ja = j_build_accel(jtris, n)
    pa = build_accel(port_tris(jtris), n)
    o, d, alive = rays(1001, seed=12)  # ragged: 125 packets + 1 ray
    alive = alive if with_alive else np.ones_like(alive)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    ta = torch.from_numpy(alive) if with_alive else None
    jp = _jax_packets(o, d, alive)
    for got, want in zip(culling.packets(to, td, ta), jp):
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(ip.packet_block_masks(*map(jnp.asarray, jp), ja))
    got = culling.packet_block_masks(to, td, ta, pa)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.3  # the comparison is not vacuous
    assert want.max() < 2**16  # 16 blocks: bits past the last block stay clear


@pytest.mark.parametrize("tile_blocks,n_tiles", [(16, 1), (6, 3)])
@pytest.mark.parametrize("granule", [1, 3, "auto"])
def test_packet_tile_words_match_jax(tile_blocks, n_tiles, granule):
    jtris, n = soup(2000, seed=13)  # 16 blocks
    ja = j_build_accel(jtris, n)
    pa = build_accel(port_tris(jtris), n)
    o, d, alive = rays(999, seed=14)
    if granule == "auto":
        g = culling.stream_granule(tile_blocks, n_tiles)
        assert g == ip._stream_granule(tile_blocks, n_tiles)
    else:
        g = granule
    want = np.asarray(ip.packet_tile_words_multi(
        *map(jnp.asarray, _jax_packets(o, d, alive)), ja, n_tiles, tile_blocks, g))
    got = culling.packet_tile_words_multi(*map(torch.from_numpy, (o, d, alive)), pa,
                                          n_tiles, tile_blocks, g)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[2] == culling.stream_words_per_pair(tile_blocks, g)
    assert (want != 0).any()


@pytest.mark.parametrize("env", ["auto", "1", "2", "max"])
def test_stream_granule_matches_jax(env, monkeypatch):
    for bpt in (1, 2, 5, 31, 32, 62, 128, 200, 512):
        value = str(bpt) if env == "max" else env
        if value != "auto" and int(value) > bpt:
            continue
        monkeypatch.setenv("RTC_STREAM_GRANULE", value)
        for n_tiles in (1, 3, 10, 64):
            assert (culling.stream_granule(bpt, n_tiles)
                    == ip._stream_granule(bpt, n_tiles)), (bpt, n_tiles, value)
            assert (culling.stream_words_per_pair(bpt, 3)
                    == ip.stream_words_per_pair(bpt, 3))


@pytest.mark.parametrize("value", ["0", "-2", "fine", "1.5", "129"])
def test_stream_granule_rejects(value, monkeypatch):
    monkeypatch.setenv("RTC_STREAM_GRANULE", value)
    with pytest.raises(ValueError, match="RTC_STREAM_GRANULE"):
        culling.stream_granule(128, 1)


def test_stream_tile_pad_matches_jax():
    jtris, n = soup(700, seed=6)  # 768 triangles
    ja = j_build_accel(jtris, n)
    pa = build_accel(port_tris(jtris), n)
    jp, jo = ip._stream_tile_pad(ja.packed_plane, ja.orig_idx.reshape(1, -1), 512)
    tp, to = culling.stream_tile_pad(pa.packed_plane, pa.orig_idx, 512)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo)[0])
    assert tp.shape == (12, 1024)
