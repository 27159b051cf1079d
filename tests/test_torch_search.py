"""Port parity: the triangle search, nearest_hit and resolve_hit.

The port's plain search (``search_brute_reference``, the CPU path of the
CUDA kernel's wrapper) is held against the JAX package's XLA search and
against its Pallas brute kernel run in interpret mode, on random triangle
soups and on ``box_scene`` + sphere. Hit flags, kinds and indices must be
EQUAL. Distances agree to rtol 1e-6 with atol 1e-5: the op sequences are
the same, but XLA:CPU contracts multiply-adds into FMA and the port does
not, which moves a distance by a few ulps where the Möller–Trumbore dot
products cancel (observed: 6.7e-6 at dst = 4.8, n_live = 40). Resolved
geometry and materials agree to rtol 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.camera import primary_rays as j_primary_rays
from raytracingc_tpu.ops.intersect import _search_triangles_xla
from raytracingc_tpu.ops.intersect import nearest_hit as j_nearest_hit
from raytracingc_tpu.ops.intersect import resolve_hit as j_resolve_hit
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.ops import search_brute as sb
from raytracingc_tpu_torch.ops.intersect import nearest_hit, ray_triangle_dst, resolve_hit

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
HIT_FIELDS = ("dst", "point", "normal", "albedo", "emission", "smoothness")


def _soup(n_live, seed):
    """Random triangles in front of a camera at the origin looking down +z;
    every 5th triangle duplicates an earlier one (lowest-index ties)."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-6, 6, size=(n_live, 3)).astype(np.float32)
    c[:, 2] += 10.0
    e1 = (rs.normal(size=(n_live, 3)) * 2.0).astype(np.float32)
    e2 = (rs.normal(size=(n_live, 3)) * 2.0).astype(np.float32)
    verts = np.stack([c, c + e1, c + e2], axis=1)
    dup = np.arange(5, n_live, 5)
    verts[dup] = verts[dup // 2]
    normals = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    # Flip half the normals so both cull outcomes occur.
    normals[::2] *= -1.0
    tris, n = jb.triangles_from_arrays(
        verts, normals.astype(np.float32), np.full((n_live, 3), 0.5, np.float32),
        np.zeros(n_live, np.float32), np.zeros(n_live, np.float32))
    return tris, n


def _rays():
    jc = JCamera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    o, d = (np.array(x) for x in j_primary_rays(jc, 16, 16))
    return o, d


def _port_tris(jtris):
    from raytracingc_tpu_torch.scene.types import Triangles

    return Triangles(**{f: torch.from_numpy(np.array(getattr(jtris, f)))
                        for f in bridge.TRIANGLE_FIELDS})


@pytest.mark.parametrize("n_live", [1, 40, 300])
@pytest.mark.parametrize("with_alive", [False, True])
def test_search_matches_xla_and_interpret_brute(n_live, with_alive):
    """n_live=300 takes the interpret kernel's fori_loop path (past
    BRUTE_UNROLL_TRIS=256); 1 and 40 its unrolled path."""
    jtris, n = _soup(n_live, seed=n_live)
    o, d = _rays()
    alive = np.random.default_rng(1).uniform(size=o.shape[0]) > 0.3
    ja = jnp.asarray(alive) if with_alive else None
    jd_br, ji_br = (np.asarray(x) for x in ip.search_triangles_pallas(
        jnp.asarray(o), jnp.asarray(d), jtris, interpret=True, n_live=n, alive=ja))
    jd_x, ji_x = (np.asarray(x) for x in _search_triangles_xla(
        jnp.asarray(o), jnp.asarray(d), jtris, chunk=128))

    tri = sb.pack_triangles(_port_tris(jtris), n)
    ta = torch.from_numpy(alive) if with_alive else None
    td, ti = sb.search_brute(torch.from_numpy(o), torch.from_numpy(d), tri, n, ta)
    td, ti = td.numpy(), ti.numpy()
    # A chunk smaller than n_live crosses chunk boundaries inside the scan.
    td_c, ti_c = sb.search_brute_reference(
        torch.from_numpy(o), torch.from_numpy(d), tri, n, ta, chunk=7)

    np.testing.assert_array_equal(ti, ji_br)
    np.testing.assert_allclose(td, jd_br, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(ti_c.numpy(), ti)
    np.testing.assert_array_equal(td_c.numpy(), td)
    live = alive if with_alive else np.ones_like(alive)
    np.testing.assert_array_equal(ti[live], ji_x[live])
    np.testing.assert_allclose(td[live], jd_x[live], rtol=1e-6, atol=1e-5)
    assert (ti[~live] == -1).all() and (td[~live] == 999999.0).all()
    if n_live > 1:
        assert (ti >= 0).sum() > 20


def test_ray_triangle_dst_matches_jax():
    from raytracingc_tpu.ops.intersect import ray_triangle_dst as j_rtd

    jtris, n = _soup(40, seed=3)
    o, d = _rays()
    args = [o[:, None, :], d[:, None, :]] + [
        np.asarray(getattr(jtris, f))[None, :n] for f in ("a", "b", "c", "normal")]
    jd, jv = (np.asarray(x) for x in j_rtd(*(jnp.asarray(a) for a in args)))
    td, tv = ray_triangle_dst(*(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(td.numpy()[jv], jd[jv], rtol=1e-6, atol=1e-5)
    assert jv.sum() > 20


def _box_scene_pair():
    """JAX box_scene (+ default sphere), and the port's copy via the bridge."""
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    npz = {
        "triangles": {f: np.asarray(getattr(js.triangles, f))
                      for f in bridge.TRIANGLE_FIELDS},
        "spheres": {f: np.asarray(getattr(js.spheres, f))
                    for f in bridge.SPHERE_FIELDS},
        "env": {f: np.asarray(getattr(js.env, f)) for f in bridge.ENV_FIELDS},
    }
    ts = bridge.scene_from_numpy(npz["triangles"], npz["spheres"], npz["env"],
                                 js.n_triangles, js.n_spheres)
    return js, ts


def _tangent_scene_pair():
    """box_scene + sphere, plus a triangle lying in the plane tangent to the
    sphere's top (y = -1.5), facing up: a ray straight down the y axis hits
    both at distance 2.5, where the sphere must win (C scan order)."""
    verts, normals, albedo, emission, smooth = (
        np.asarray(x) for x in jb.load_triangles_txt(BOX_SCENE))
    tan = np.array([[[-1.0, -1.5, -1.0], [1.0, -1.5, -1.0], [0.0, -1.5, 1.0]]],
                   np.float32)
    verts = np.concatenate([verts, tan])
    normals = np.concatenate([normals, [[0.0, -1.0, 0.0]]]).astype(np.float32)
    albedo = np.concatenate([albedo, [[0.3, 0.3, 0.3]]]).astype(np.float32)
    emission = np.concatenate([emission, [0.0]]).astype(np.float32)
    smooth = np.concatenate([smooth, [0.0]]).astype(np.float32)
    jtris, n = jb.triangles_from_arrays(verts, normals, albedo, emission, smooth)
    js0 = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    js = js0.replace(triangles=jtris, n_triangles=n, accel=None)
    ts = bridge.scene_from_numpy(
        {f: np.asarray(getattr(jtris, f)) for f in bridge.TRIANGLE_FIELDS},
        {f: np.asarray(getattr(js.spheres, f)) for f in bridge.SPHERE_FIELDS},
        {f: np.asarray(getattr(js.env, f)) for f in bridge.ENV_FIELDS},
        n, js.n_spheres)
    return js, ts


def _box_rays():
    """Primary rays of the default camera, random rays from inside the box,
    and one ray straight down onto the sphere's top."""
    o0, d0 = (np.array(x) for x in j_primary_rays(JCamera.look_at(), 16, 16))
    rs = np.random.default_rng(4)
    o1 = rs.uniform(-5, 1.5, size=(512, 3)).astype(np.float32)
    d1 = rs.normal(size=(512, 3)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    o = np.concatenate([o0, o1, [[0.0, -4.0, 0.0]]]).astype(np.float32)
    d = np.concatenate([d0, d1, [[0.0, 1.0, 0.0]]]).astype(np.float32)
    return o, d


@pytest.mark.parametrize("tangent", [False, True])
def test_nearest_hit_and_resolve_box_scene(tangent):
    js, ts = _tangent_scene_pair() if tangent else _box_scene_pair()
    o, d = _box_rays()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jref = j_nearest_hit(jo, jd, js, backend="xla")
    jhit = j_resolve_hit(jo, jd, jref, js)
    jref = {f: np.asarray(getattr(jref, f)) for f in ("hit", "is_tri", "idx")}
    jhit = {f: np.asarray(getattr(jhit, f)) for f in ("hit",) + HIT_FIELDS}

    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tref = nearest_hit(to, td, ts)
    thit = resolve_hit(to, td, tref, ts)

    for f in ("hit", "is_tri", "idx"):
        np.testing.assert_array_equal(getattr(tref, f).numpy(), jref[f], err_msg=f)
    np.testing.assert_array_equal(thit.hit.numpy(), jhit["hit"])
    for f in HIT_FIELDS:
        np.testing.assert_allclose(getattr(thit, f).numpy(), jhit[f], rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    hit, is_tri = jref["hit"], jref["is_tri"]
    assert (hit & is_tri).sum() > 100 and (hit & ~is_tri).sum() > 10
    if tangent:
        # The last ray: the sphere and the tangent triangle tie at 2.5.
        assert thit.dst[-1].item() == 2.5
        assert bool(tref.hit[-1]) and not bool(tref.is_tri[-1])
        assert int(tref.idx[-1]) == 0


def test_search_backends_agree_and_validate(monkeypatch):
    js, ts = _box_scene_pair()
    o, d = (torch.from_numpy(x) for x in _box_rays())
    auto = nearest_hit(o, d, ts, backend="auto")
    plain = nearest_hit(o, d, ts, backend="xla")
    for f in ("hit", "is_tri", "idx"):
        assert torch.equal(getattr(auto, f), getattr(plain, f)), f
    with pytest.raises(RuntimeError, match="CUDA"):
        nearest_hit(o, d, ts, backend="pallas")
    with pytest.raises(ValueError):
        nearest_hit(o, d, ts, backend="mosaic")

    tri = sb.pack_triangles(ts.triangles, ts.n_triangles)
    with pytest.raises(ValueError):
        sb.search_brute(o.double(), d, tri, ts.n_triangles)
    with pytest.raises(ValueError):
        sb.search_brute(o, d[:5], tri, ts.n_triangles)
    with pytest.raises(ValueError):
        sb.search_brute(o, d, tri, tri.shape[0] + 1)
    with pytest.raises(ValueError):
        sb.search_brute(o.t().contiguous().t(), d, tri, ts.n_triangles)
    with pytest.raises(RuntimeError, match="no kernel"):
        sb.search_brute(o.to("meta"), d.to("meta"), tri.to("meta"), ts.n_triangles)

    # The packet kernels' plain versions give the brute scan's winners.
    monkeypatch.setenv("RTC_KERNEL", "packet")
    packet = nearest_hit(o, d, ts)
    assert torch.equal(packet.idx, plain.idx)
    # The MXU route's plain version gives the brute scan's winners, in both
    # precisions (none of these rays lies at a validity boundary, where the
    # contract would allow a flip).
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    for prec in ("split3", "highest"):
        monkeypatch.setenv("RTC_MXU_PRECISION", prec)
        mxu = nearest_hit(o, d, ts)
        for f in ("hit", "is_tri", "idx"):
            assert torch.equal(getattr(mxu, f), getattr(plain, f)), (prec, f)
    assert (plain.hit & plain.is_tri).sum() > 100
    monkeypatch.delenv("RTC_MXU_PRECISION")
    monkeypatch.setenv("RTC_KERNEL", "brutte")
    with pytest.raises(ValueError):
        nearest_hit(o, d, ts)
    monkeypatch.setenv("RTC_KERNEL", "brute")
    monkeypatch.setenv("RTC_BRUTE_MAX", "-3")
    with pytest.raises(ValueError):
        nearest_hit(o, d, ts)
    # Past RTC_BRUTE_MAX auto dispatch takes the bitmask route.
    monkeypatch.setenv("RTC_KERNEL", "auto")
    monkeypatch.setenv("RTC_BRUTE_MAX", "4")
    small = nearest_hit(o, d, ts)
    assert torch.equal(small.idx, plain.idx)
