"""Port parity: the block-AABB accel and the culling preludes.

``build_accel``, ``trivial_accel``, the slab-test words of the bitmask and
packed kernels and the culling granule are integer (or copied float) results
of the same numpy or elementwise op sequences in both packages, so they must
be EQUAL bit for bit.
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
    assert pa.n_blocks == t // 128 and pa.mxu_coeffs is None
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
    o_p, d_p, a_p = culling.packets(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(alive) if with_alive else None)
    for got, want in zip((o_p, d_p, a_p), _jax_packets(o, d, alive)):
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(ip.packet_block_masks(
        jnp.asarray(o_p.numpy()), jnp.asarray(d_p.numpy()),
        jnp.asarray(a_p.numpy()), ja))
    got = culling.packet_block_masks(o_p, d_p, a_p, pa)
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
    o_p, d_p, a_p = culling.packets(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(alive))
    if granule == "auto":
        g = culling.stream_granule(tile_blocks, n_tiles)
        assert g == ip._stream_granule(tile_blocks, n_tiles)
    else:
        g = granule
    want = np.asarray(ip.packet_tile_words_multi(
        jnp.asarray(o_p.numpy()), jnp.asarray(d_p.numpy()),
        jnp.asarray(a_p.numpy()), ja, n_tiles, tile_blocks, g))
    got = culling.packet_tile_words_multi(o_p, d_p, a_p, pa, n_tiles,
                                          tile_blocks, g)
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
