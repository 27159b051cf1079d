"""Port parity: the bitmask (K2) and packed (K3) packet searches and dispatch.

The port's dispatch (``ops/search.py``) on CPU tensors runs each kernel's
plain version; it is held against the JAX package's auto dispatch with the
Pallas kernels in interpret mode, on 1,800-triangle soups through the
bitmask, packed-resident and packed-streamed branches, with mixed rays and
with secondary-like packets (shared origins, independent directions) on a
soup of duplicated triangles, whose ties must go to the lowest original
index. Winning indices must be EQUAL on every lane, dead lanes included.
Distances agree to rtol 1e-6 with atol 1e-5: XLA:CPU contracts the
Möller–Trumbore multiply-adds into FMA and the port does not (ROADMAP Queue
3 P1). Live lanes must also win the same triangles at the same distances as
the port's brute scan over all live triangles.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops.accel import build_accel
from raytracingc_tpu_torch.ops.intersect import nearest_hit
from raytracingc_tpu_torch.ops.search_bitmask import (
    bitmask_table,
    search_bitmask,
    search_bitmask_reference,
    search_blocks_reference,
)
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute_reference
from raytracingc_tpu_torch.ops.search_packed import search_packed, search_packed_reference
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.tools.packets import secondary_rays
from test_torch_accel import port_tris, soup

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
KNOBS = ("RTC_KERNEL", "RTC_CULL", "RTC_STREAM_CULL", "RTC_BRUTE_MAX",
         "RTC_BITMASK_MAX_WORDS", "RTC_STREAM_MAX_T", "RTC_STREAM_TILE",
         "RTC_STREAM_GRANULE", "RTC_COL_GROUP", "RTC_RESOLVE",
         "RTC_STREAM_ORDER", "RTC_EXTRACT", "RTC_MXU_PRECISION")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def rays_at(r, seed):
    """Rays from a 10-unit cube; every 4th ray aims at a triangle so that
    hits are plentiful, 30% of lanes dead."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-5, 5, (r, 3)).astype(np.float32)
    target = rs.uniform(-3, 3, (r, 3)).astype(np.float32)
    d = np.where(np.arange(r)[:, None] % 4 == 0, target - o,
                 rs.normal(size=(r, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rs.uniform(size=r) >= 0.3
    return o, d, alive


def dup_soup(n, seed):
    """:func:`soup` with every 7th triangle a copy of an earlier one (same
    vertices and normal), so that equal distances occur: the winner must
    be the lowest original index. Returns ``(JAX Triangles, n, copied)``,
    ``copied`` the original indices that have a later copy."""
    rs = np.random.default_rng(seed)
    a = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    b = a + rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    c = a + rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    verts = np.stack([a, b, c], 1)
    dup = np.arange(7, n, 7)
    verts[dup] = verts[dup // 2]
    nrm = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    tris, n_live = jb.triangles_from_arrays(
        verts, nrm.astype(np.float32), np.full((n, 3), 0.5, np.float32),
        np.zeros(n, np.float32), np.zeros(n, np.float32))
    return tris, n_live, dup // 2


# (name, env, expected port route, rays): the rays of rays_at on a soup, and
# secondary-like packets (secondary_rays) on a soup with duplicated
# triangles through K2 and K3 resident, streamed at granule 1 and at the
# auto granule over a ragged last tile.
BRANCHES = [
    ("bitmask", {}, "bitmask", "mixed"),
    ("packed_resident", {"RTC_BITMASK_MAX_WORDS": "0"}, "packed", "mixed"),
    ("packed_resident_g3", {"RTC_BITMASK_MAX_WORDS": "0",
                            "RTC_STREAM_GRANULE": "3"}, "packed", "mixed"),
    ("packed_streamed", {"RTC_STREAM_MAX_T": "256", "RTC_STREAM_TILE": "256"},
     "packed", "mixed"),
    ("packed_streamed_ragged", {"RTC_STREAM_MAX_T": "256",
                                "RTC_STREAM_TILE": "512"}, "packed", "mixed"),
    ("incoherent_bitmask", {}, "bitmask", "incoherent"),
    ("incoherent_packed_resident", {"RTC_BITMASK_MAX_WORDS": "0"}, "packed",
     "incoherent"),
    ("incoherent_packed_streamed_g1", {"RTC_STREAM_MAX_T": "256",
                                       "RTC_STREAM_TILE": "256",
                                       "RTC_STREAM_GRANULE": "1"}, "packed",
     "incoherent"),
    ("incoherent_packed_streamed_auto", {"RTC_STREAM_MAX_T": "256",
                                         "RTC_STREAM_TILE": "512"}, "packed",
     "incoherent"),
]


@pytest.mark.parametrize("name,env,kernel,rays", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_packet_search_matches_interpret_pallas(name, env, kernel, rays, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if rays == "mixed":
        jtris, n = soup(1800, seed=21)  # 1,920 padded = 15 blocks
        o, d, alive = rays_at(1003, seed=22)  # ragged: 125 packets + 3 rays
    else:
        jtris, n, copied = dup_soup(1800, seed=41)
        o, d, alive = secondary_rays(np.random.default_rng(42), 1003, -4.0, 4.0)
    jd, ji = (np.asarray(x) for x in ip.search_triangles_pallas(
        jnp.asarray(o), jnp.asarray(d), jtris, interpret=True,
        alive=jnp.asarray(alive), accel=j_build_accel(jtris, n), n_live=n))

    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    assert search.route(n, accel.n_blocks, search.Knobs.read()).kernel == kernel
    pd, pi = search.search_triangles(to, td, tris, n, alive=ta, accel=accel)
    pd, pi = pd.numpy(), pi.numpy()

    np.testing.assert_array_equal(pi, ji)  # every lane, dead ones included
    np.testing.assert_allclose(pd, jd, rtol=1e-6, atol=1e-5)
    bd, bi = search_brute_reference(to, td, pack_triangles(tris, n), n, ta)
    np.testing.assert_array_equal(pi[alive], bi.numpy()[alive])
    np.testing.assert_array_equal(pd[alive], bd.numpy()[alive])
    assert (pi[alive] >= 0).sum() > 100  # the comparison is not vacuous
    # Dead lanes of packets with a live lane get their real hit; the brute
    # route would have masked them.
    assert ((pi >= 0) & ~alive).sum() > 10
    if rays == "incoherent":
        # Ties occur: live winners whose triangle has a later copy at the
        # same distance, resolved to the original.
        assert np.isin(pi[alive], copied).sum() > 10
        # The packets are incoherent: each tests much of the scene.
        words = culling.packet_block_masks(to, td, ta, accel)
        per_packet = bitmask_table(words, accel.n_blocks).sum(1).float()
        assert per_packet[culling.packets(to, td, ta)[2].any(1)].mean() > 0.3 * accel.n_blocks


def test_plain_versions_direct():
    """The wrappers' CPU path IS the plain version, with the same bits for
    any chunking of the (packet, block) pairs."""
    jtris, n = soup(1700, seed=23)
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    o, d, alive = rays_at(517, seed=24)
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    plane, oi = accel.packed_plane, accel.orig_idx

    words = culling.packet_block_masks(to, td, ta, accel)
    k2 = search_bitmask(to, td, words, plane, oi)
    ref = search_bitmask_reference(to, td, words, plane, oi)
    assert all(torch.equal(a, b) for a, b in zip(ref, k2))

    tile, n_tiles = 512, 4
    plane_t, oi_t = culling.stream_tile_pad(plane, oi, tile)
    for g in (1, 2, 4):
        tw = culling.packet_tile_words_multi(to, td, ta, accel, n_tiles,
                                             tile // 128, g)
        k3 = search_packed(to, td, tw, plane_t, oi_t, tile, g)
        ref = search_packed_reference(to, td, tw, plane_t, oi_t, tile, g)
        assert all(torch.equal(a, b) for a, b in zip(ref, k3))
        # Live lanes win the same triangles at any granule (a coarser
        # granule tests a superset of their hit blocks); dead lanes see the
        # blocks their packet tests, the same ones at granule 1.
        lanes = slice(None) if g == 1 else ta
        assert torch.equal(k3[1][lanes], k2[1][lanes])
        assert torch.equal(k3[0][lanes], k2[0][lanes])
    small = search_blocks_reference(to, td, plane, oi,
                                    bitmask_table(words, accel.n_blocks), chunk=7)
    assert all(torch.equal(a, b) for a, b in zip(small, k2))


def test_packet_wrappers_validate():
    jtris, n = soup(300, seed=1)
    accel = build_accel(port_tris(jtris), n)
    o = torch.zeros((16, 3))
    d = torch.ones((16, 3))
    w = torch.zeros((2, 1), dtype=torch.int32)
    plane, oi = accel.packed_plane, accel.orig_idx
    with pytest.raises(ValueError, match="words"):
        search_bitmask(o, d, w[:1], plane, oi)
    with pytest.raises(ValueError, match="words"):
        search_bitmask(o, d, w.float(), plane, oi)
    with pytest.raises(ValueError, match="plane"):
        search_bitmask(o, d, w, plane[:, :100].contiguous(), oi[:100].contiguous())
    with pytest.raises(ValueError, match="orig_idx"):
        search_bitmask(o, d, w, plane, oi.long())
    with pytest.raises(RuntimeError, match="no kernel"):
        search_bitmask(o.to("meta"), d.to("meta"), w.to("meta"),
                       plane.to("meta"), oi.to("meta"))
    tw = torch.zeros((2, 3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="tile"):
        search_packed(o, d, tw, plane, oi, 200, 1)
    with pytest.raises(ValueError, match="granule"):
        search_packed(o, d, tw, plane, oi, 128, 2)
    with pytest.raises(ValueError, match="words"):
        search_packed(o, d, tw[:, :, :0].contiguous(), plane, oi, 128, 1)
    # Zero bits anywhere: every ray misses.
    dst, idx = search_packed(o, d, tw, plane, oi, 128, 1)
    assert (idx == -1).all() and (dst == 999999.0).all()


@pytest.fixture
def spies(monkeypatch):
    calls = []
    for name in ("search_brute", "search_bitmask", "search_packed"):
        real = getattr(search, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(search, name, spy)
    return calls


def test_routing_table(spies, monkeypatch):
    """The JAX package's auto dispatch, branch by branch: brute up to 1,536
    live triangles, bitmask up to 8 words (248 blocks), packed past them,
    streamed past RTC_STREAM_MAX_T; RTC_BRUTE_MAX and RTC_KERNEL override."""
    o, d, _ = rays_at(64, seed=31)
    to, td = torch.from_numpy(o), torch.from_numpy(d)

    def run(n_tris, seed=3):
        jtris, n = soup(n_tris, seed=seed)
        tris = port_tris(jtris)
        accel = build_accel(tris, n)
        spies.clear()
        search.search_triangles(to, td, tris, n, accel=accel)
        return list(spies), search.route(n, accel.n_blocks, search.Knobs.read())

    assert run(1500)[0] == ["search_brute"]
    assert run(1600)[0] == ["search_bitmask"]
    # No rays: every route returns empty results.
    jtris, n = soup(1600, seed=3)
    tris = port_tris(jtris)
    for env in ({}, {"RTC_BITMASK_MAX_WORDS": "0"}, {"RTC_BRUTE_MAX": "9999"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            dst, idx = search.search_triangles(to[:0], td[:0], tris, n,
                                               accel=build_accel(tris, n))
        assert dst.shape == idx.shape == (0,)
    assert run(31744)[0] == ["search_bitmask"]  # 248 blocks: 8 words
    calls, way = run(31745)  # 249 blocks: packed, one resident tile
    assert calls == ["search_packed"]
    assert (way.tile, way.n_tiles, way.granule) == (31872, 1, 1)

    monkeypatch.setenv("RTC_STREAM_MAX_T", "1024")
    calls, way = run(1600)  # 1,664 padded > 1,024: streamed
    assert calls == ["search_packed"]
    assert (way.tile, way.n_tiles) == (1664, 1)  # tile capped at the plane
    monkeypatch.setenv("RTC_STREAM_TILE", "300")  # rounds up to 384
    calls, way = run(1600)
    assert (way.tile, way.n_tiles) == (384, 5)
    assert way.granule == ip._stream_granule(3, 5)
    monkeypatch.delenv("RTC_STREAM_MAX_T")
    monkeypatch.delenv("RTC_STREAM_TILE")

    monkeypatch.setenv("RTC_BRUTE_MAX", "100")
    assert run(1500)[0] == ["search_bitmask"]
    monkeypatch.setenv("RTC_BRUTE_MAX", "2000")
    assert run(1600)[0] == ["search_brute"]
    monkeypatch.setenv("RTC_KERNEL", "packet")
    assert run(300)[0] == ["search_bitmask"]
    monkeypatch.setenv("RTC_KERNEL", "brute")
    assert run(2000)[0] == ["search_brute"]
    monkeypatch.delenv("RTC_KERNEL")
    monkeypatch.delenv("RTC_BRUTE_MAX")
    # A scene without an accel searches through the trivial accel.
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    monkeypatch.setenv("RTC_BRUTE_MAX", "0")
    bare = type(ts)(triangles=ts.triangles, spheres=ts.spheres, env=ts.env,
                    n_triangles=ts.n_triangles, n_spheres=ts.n_spheres)
    spies.clear()
    a = nearest_hit(to, td, bare)
    b = nearest_hit(to, td, ts)
    assert spies == ["search_bitmask", "search_bitmask"]
    assert torch.equal(a.idx, b.idx)


@pytest.mark.parametrize(
    "env,exc",
    [
        ({"RTC_MXU_PRECISION": "high"}, ValueError),
        ({"RTC_STREAM_ORDER": "tiles"}, ValueError),
        ({"RTC_EXTRACT": "rolll"}, ValueError),
        ({"RTC_STREAM_ORDER": "ray-major"}, ValueError),
        ({"RTC_KERNEL": "bitmask"}, ValueError),
        ({"RTC_CULL": "bitmsk"}, ValueError),
        ({"RTC_STREAM_CULL": "pack"}, ValueError),
        ({"RTC_COL_GROUP": "3"}, ValueError),
        ({"RTC_COL_GROUP": "eight"}, ValueError),
        ({"RTC_STREAM_GRANULE": "0"}, ValueError),
        ({"RTC_STREAM_GRANULE": "fine"}, ValueError),
        ({"RTC_STREAM_TILE": "0"}, ValueError),
        ({"RTC_STREAM_MAX_T": "-1"}, ValueError),
        ({"RTC_BITMASK_MAX_WORDS": "many"}, ValueError),
        ({"RTC_BRUTE_MAX": "-1"}, ValueError),
    ],
)
def test_knobs_validated_on_every_path(env, exc, monkeypatch):
    """On the brute route too (box_scene, 10 triangles): no knob is read
    only on the branch that uses it."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    o, d, _ = rays_at(16, seed=0)
    with pytest.raises(exc, match=next(iter(env))):
        nearest_hit(torch.from_numpy(o), torch.from_numpy(d), ts)


def test_granule_out_of_range_raises(monkeypatch):
    monkeypatch.setenv("RTC_BITMASK_MAX_WORDS", "0")
    monkeypatch.setenv("RTC_STREAM_GRANULE", "16")  # 15 blocks per tile
    jtris, n = soup(1800, seed=21)
    tris = port_tris(jtris)
    o, d, _ = rays_at(16, seed=0)
    with pytest.raises(ValueError, match="RTC_STREAM_GRANULE"):
        search.search_triangles(torch.from_numpy(o), torch.from_numpy(d), tris,
                                n, accel=build_accel(tris, n))
