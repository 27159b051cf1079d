"""Port parity: the MXU search (K8), its table, features and culling words.

The port's plain version (``ops/intersect_mxu.py::search_mxu_reference``, the
CPU side of ``search_mxu``) is held against the JAX package's K8 in
interpret mode (``search_triangles_pallas(variant="mxu")``, as
``tests/test_intersect_mxu.py`` runs it). The split bits, the features and the
union words are exact and must be EQUAL; the coefficient table differs only
by XLA:CPU's FMA contraction (``test_torch_accel.assert_mxu_table_matches``).
The search is held to the kernel's contract: dead lanes exactly (MISS_DST,
-1); winners equal except flips at a validity boundary (f64 margin < 1e-3 of
one of the two triangles) on at most 0.5% of the lanes; distances of
agreeing hits within 2e-4 relative, JAX's own bound against the f32 search
(the t′ plane is an XLA HIGHEST dot there and a fixed-order f32 sum here,
and t′ cancels: 2.6e-5 was seen on this fixture).
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.ops import intersect_mxu as jm
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.cli import main
from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops import intersect_mxu as pm
from raytracingc_tpu_torch.ops.accel import build_accel
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute_reference
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.scene.types import MISS_DST
from raytracingc_tpu_torch.tools.packets import packet_rays
from test_intersect_mxu import _boundary_margin, _random_rays, _random_soup
from test_torch_accel import assert_mxu_table_matches, port_tris, soup
from test_torch_search_packet import KNOBS

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
FLIP_MARGIN = 1e-3
MAX_FLIP_FRAC = 0.005
DST_RTOL = 2e-4


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box_x3():
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    return jb.tessellate(js.triangles, js.n_triangles, levels=3)


@pytest.mark.parametrize("case", ["soup300", "box_x3"])
def test_pack_coeffs_mxu_matches_jax(case):
    jtris, n = _random_soup() if case == "soup300" else _box_x3()
    ja = j_build_accel(jtris, n)
    pa = build_accel(port_tris(jtris), n)
    assert_mxu_table_matches(pa.mxu_coeffs.numpy(), ja)
    # The accel's eager table is pack_coeffs_mxu of its permuted triangles,
    # and the bridge carries JAX's table as it is.
    assert torch.equal(pa.mxu_coeffs, pm.pack_coeffs_mxu(pa.triangles, pa.orig_idx))
    carried = bridge.accel_from_numpy(bridge.accel_arrays(ja)).mxu_coeffs
    np.testing.assert_array_equal(carried.numpy(), np.asarray(ja.mxu_coeffs))
    # Padding rows are zero and the index plane is exact.
    blocks = pa.mxu_coeffs.reshape(-1, 6, 128, 16)
    assert torch.equal(blocks[:, 5, :, 0].reshape(-1),
                       pa.orig_idx.clamp_max(2**30).float())
    assert (blocks[:, :5].reshape(5, -1, 16)[:, :, 13:] == 0).all()


def test_no_table_past_the_cap():
    jtris, n = soup(pm.MXU_MAX_TRIS + 1, seed=4)  # 8,320 padded
    assert j_build_accel(jtris, n).mxu_coeffs is None
    assert build_accel(port_tris(jtris), n).mxu_coeffs is None
    jtris, n = soup(pm.MXU_MAX_TRIS, seed=4)  # exactly at the cap
    assert build_accel(port_tris(jtris), n).mxu_coeffs.shape == (6 * 8192, 16)


def test_split_bf16_and_features_match_jax():
    rs = np.random.default_rng(3)
    x = (rs.normal(size=4096) * 10.0 ** rs.integers(-30, 30, 4096)).astype(np.float32)
    x[:8] = [0.0, -0.0, 1.0, 2**30, 255.0, 256.0, 3.0e38, 1e-40]
    jh, jl = (np.asarray(v).view(np.uint16) for v in jm._split_bf16(jnp.asarray(x)))
    th, tl = (v.view(torch.int16).numpy().view(np.uint16)
              for v in pm.split_bf16(torch.from_numpy(x)))
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tl, jl)

    r = 2048
    o = rs.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = rs.normal(size=(r, 3)).astype(np.float32)
    planes = lambda v: v.reshape(r // 8, 8, 3).transpose(2, 1, 0)  # (3, 8, C)
    rays = np.concatenate([planes(o), planes(d), np.ones((1, 8, r // 8), np.float32)])
    jf = np.asarray(jm._build_features(jnp.asarray(rays)))  # (16, R), lane s*C + c
    tf = pm.build_features(torch.from_numpy(o), torch.from_numpy(d)).numpy()
    ray_of_lane = (np.arange(r) % (r // 8)) * 8 + np.arange(r) // (r // 8)
    np.testing.assert_array_equal(tf[ray_of_lane].T.view(np.int32), jf.view(np.int32))


@pytest.mark.parametrize("with_alive", [False, True])
def test_program_union_words_match_jax(with_alive):
    jtris, n = soup(4000, seed=11)  # 32 blocks: two words
    ja = j_build_accel(jtris, n)
    pa = build_accel(port_tris(jtris), n)
    rs = np.random.default_rng(12)
    r = 2500  # 3 programs, the last one ragged
    o = rs.uniform(-5, 5, (r, 3)).astype(np.float32)
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = np.ones(r, bool)
    if with_alive:
        alive = rs.uniform(size=r) >= 0.3
        alive[1024:2048] = False  # a dead program
    # The JAX launcher's prelude (intersect_pallas.py:2061-2067).
    r_pad = 3 * 1024
    pad = lambda v: np.pad(v, ((0, r_pad - r), (0, 0))).reshape(-1, 8, 3)
    masks = ip.packet_block_masks(jnp.asarray(pad(o)), jnp.asarray(pad(d)),
                                  jnp.asarray(np.pad(alive, (0, r_pad - r)).reshape(-1, 8)),
                                  ja)
    words = jax.lax.reduce(masks.reshape(3, 128, masks.shape[1]), jnp.int32(0),
                           jax.lax.bitwise_or, (1,))
    flags = jnp.max((words != 0).astype(jnp.int32), axis=1)
    got_w, got_f = culling.program_union_words(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(alive) if with_alive else None, pa)
    assert got_w.dtype == got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(words))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(flags))
    assert np.asarray(flags).tolist() == ([1, 0, 1] if with_alive else [1, 1, 1])
    assert (np.asarray(words)[:, 1] != 0).any()


def _assert_contract(o, d, jtris, got, want, alive=None):
    """``got`` against ``want`` (``(dst, idx)`` numpy) within the contract."""
    (gd, gi), (wd, wi) = got, want
    live = np.ones(gi.shape, bool) if alive is None else alive
    if alive is not None:
        for dst, idx in (got, want):
            assert (idx[~alive] == -1).all() and (dst[~alive] == MISS_DST).all()
    flips = np.nonzero(live & (gi != wi))[0]
    assert len(flips) <= max(1, int(MAX_FLIP_FRAC * live.sum())), len(flips)
    for i in flips:
        margins = [_boundary_margin(o[i], d[i], jtris, int(t))
                   for t in (gi[i], wi[i]) if t >= 0]
        assert margins and min(margins) < FLIP_MARGIN, (i, margins)
    agree = live & (gi == wi) & (gi >= 0)
    assert agree.sum() > 100
    np.testing.assert_allclose(gd[agree], wd[agree], rtol=DST_RTOL)
    return len(flips)


@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("precision", ["split3", "highest"])
def test_search_matches_interpret_k8(precision, with_alive, monkeypatch):
    monkeypatch.setenv("RTC_MXU_PRECISION", precision)
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    jtris, n = _random_soup()
    ja = j_build_accel(jtris, n)
    o, d = _random_rays(11)
    alive = (np.arange(o.shape[0]) % 3 != 0) if with_alive else None
    jd, ji = (np.asarray(x) for x in ip.search_triangles_pallas(
        o, d, jtris, interpret=True, accel=ja, n_live=n, variant="mxu",
        alive=None if alive is None else jnp.asarray(alive)))
    # The same table on both sides: the bridge carries JAX's accel.
    pa = bridge.accel_from_numpy(bridge.accel_arrays(ja))
    to, td = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    pd, pi = search.search_triangles(
        to, td, port_tris(jtris), n, accel=pa,
        alive=None if alive is None else torch.from_numpy(alive))
    _assert_contract(np.asarray(o), np.asarray(d), jtris, (pd.numpy(), pi.numpy()),
                     (jd, ji), alive)


def test_highest_winners_equal_the_brute_scan(monkeypatch):
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    monkeypatch.setenv("RTC_MXU_PRECISION", "highest")
    jtris, n = _random_soup()
    tris = port_tris(jtris)
    o, d = (torch.from_numpy(np.array(x)) for x in _random_rays(11))
    pd, pi = search.search_triangles(o, d, tris, n, accel=build_accel(tris, n))
    bd, bi = search_brute_reference(o, d, pack_triangles(tris, n), n)
    assert torch.equal(pi, bi) and (bi >= 0).sum() > 100
    torch.testing.assert_close(pd[bi >= 0], bd[bi >= 0], rtol=DST_RTOL, atol=0)


def test_tie_takes_the_lowest_original_index(monkeypatch):
    """Three equal triangles, the first moved behind: index 1 wins."""
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    tri = np.array([[[-2, -2, 3], [2, -2, 3], [0, 2, 3]]], np.float32)
    verts = np.concatenate([tri, tri, tri], axis=0)
    verts[0, :, 2] = 5.0
    nrm = -np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tris, n = tb.triangles_from_arrays(
        verts, nrm, np.full((3, 3), 0.5, np.float32), np.zeros(3, np.float32),
        np.zeros(3, np.float32))
    o = torch.zeros((8, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    for precision in pm.PRECISIONS:
        monkeypatch.setenv("RTC_MXU_PRECISION", precision)
        dst, idx = search.search_triangles(o, d, tris, n, accel=build_accel(tris, n))
        assert (idx == 1).all() and torch.allclose(dst, torch.full((8,), 3.0))


@pytest.mark.parametrize("precision", ["split3", "highest"])
def test_search_slicing_exact(precision, monkeypatch):
    """Per-lane results do not depend on the batch: R rays in one call equal
    two calls of whole programs, bit for bit."""
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    monkeypatch.setenv("RTC_MXU_PRECISION", precision)
    jtris, n = _random_soup(seed=9, t=200)
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    o, d = (torch.from_numpy(np.array(x)) for x in _random_rays(13, r=2048))
    alive = torch.arange(2048) % 5 != 0
    full = search.search_triangles(o, d, tris, n, alive=alive, accel=accel)
    parts = [search.search_triangles(o[s], d[s], tris, n, alive=alive[s], accel=accel)
             for s in (slice(0, 1024), slice(1024, None))]
    assert torch.equal(full[1], torch.cat([p[1] for p in parts]))
    assert torch.equal(full[0].view(torch.int32),
                       torch.cat([p[0] for p in parts]).view(torch.int32))
    assert (full[1] >= 0).sum() > 100


def test_oversize_falls_back_with_the_notice(monkeypatch, capsys):
    """Past 8,192 padded triangles mxu prints the JAX package's notice and
    takes the packet route: the result IS RTC_KERNEL=packet's."""
    rs = np.random.default_rng(11)
    n = pm.MXU_MAX_TRIS + 128
    a = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    b = a + rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    c = a + rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    nm = np.cross(b - a, c - a)
    nm /= np.maximum(np.linalg.norm(nm, axis=1, keepdims=True), 1e-20)
    tris, n_live = tb.triangles_from_arrays(
        np.stack([a, b, c], 1), nm, np.full((n, 3), 0.5, np.float32),
        np.zeros(n, np.float32), np.zeros(n, np.float32))
    accel = build_accel(tris, n_live)
    assert accel.mxu_coeffs is None and not search.mxu_fits(accel.n_blocks)
    o = torch.from_numpy(rs.uniform(-1, 1, (1024, 3)).astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(1024, 1)
    monkeypatch.setenv("RTC_KERNEL", "packet")
    want = search.search_triangles(o, d, tris, n_live, accel=accel)
    assert "unsupported" not in capsys.readouterr().err
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    got = search.search_triangles(o, d, tris, n_live, accel=accel)
    assert "RTC_KERNEL=mxu unsupported at 8320 padded triangles" in capsys.readouterr().err
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert (want[1] >= 0).sum() > 50


def test_render_matches_jax_mxu_render(monkeypatch):
    """box_scene 32x32, 2 spp, 3 bounces under RTC_KERNEL=mxu, against the
    JAX render under the same knob (interpret-mode K8), at the bound of
    tests/test_intersect_mxu.py::test_mxu_render_end_to_end_matches_xla."""
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    want, jn = j_render(js, JCamera.look_at(), 32, 32, spp=2, max_bounce=3,
                        backend="pallas")
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    got, n = render(ts, Camera.look_at(), 32, 32, spp=2, max_bounce=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    assert abs(n - int(jn)) <= 1e-3 * int(jn)


def test_render_chunking_invariance(monkeypatch):
    """The port's mxu render at two pixel chunks, within the bound of
    test_torch_render.py::test_render_chunking_invariance (ROADMAP P3)."""
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    cam = Camera.look_at()
    a, na = render(ts, cam, 64, 32, 2, 3, seed=3)
    b, nb = render(ts, cam, 64, 32, 2, 3, seed=3, pixel_chunk=1024)
    assert na == nb
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0)


def _cli_rays(argv, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv + ["--device", "cpu", "--profile"]) == 0
    for k in env:
        monkeypatch.delenv(k)
    return int(re.search(r"rays=(\d+)", buf.getvalue()).group(1))


def test_cli_mxu_route(tmp_path, monkeypatch):
    argv = ["--triangles", BOX_SCENE, "--tessellate", "3", "-s", "16", "16",
            "--spp", "2", "-b", "3"]
    want = _cli_rays(argv + ["-o", str(tmp_path / "b.bmp")], {}, monkeypatch)
    for prec in pm.PRECISIONS:
        out = tmp_path / f"{prec}.bmp"
        got = _cli_rays(argv + ["-o", str(out)],
                        {"RTC_KERNEL": "mxu", "RTC_MXU_PRECISION": prec}, monkeypatch)
        assert out.stat().st_size > 0
        assert abs(got - want) <= 1e-3 * want and want > 500


def test_search_mxu_validates():
    jtris, n = _random_soup(t=200)
    accel = build_accel(port_tris(jtris), n)
    o, d = torch.zeros((16, 3)), torch.ones((16, 3))
    w, f = culling.program_union_words(o, d, None, accel)
    args = (o, d, w, f, accel.mxu_coeffs, accel.orig_idx)
    with pytest.raises(ValueError, match="precision"):
        pm.search_mxu(*args, "high")
    with pytest.raises(ValueError, match="flags"):
        pm.search_mxu(o, d, w, f.bool(), *args[4:])
    with pytest.raises(ValueError, match="coeffs"):
        pm.search_mxu(o, d, w, f, accel.mxu_coeffs[:-16], accel.orig_idx)
    with pytest.raises(ValueError, match="alive"):
        pm.search_mxu(*args, alive=torch.ones(15, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="no kernel"):
        pm.search_mxu(*(x.to("meta") for x in args))
    with pytest.raises(ValueError, match="128"):
        pm.pack_coeffs_mxu(type(accel.triangles)(**{
            k: v[:100] for k, v in vars(accel.triangles).items()}), accel.orig_idx[:100])
    dst, idx = pm.search_mxu(*args)
    assert idx.shape == (16,) and idx.dtype == torch.int32


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library at
    module level; ``main`` is not run)."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_contract_catches_split3_held_to_highest():
    """chip_smoke.py's K8 contract on the plain versions: highest against
    itself passes; split3's products held to highest's plain version (the
    smoke's control) break it, on grazing hits too, where kappa widens the
    bound."""
    cs = _chip_smoke()
    rng = np.random.default_rng(7)
    tris, n, (lo, hi) = cs.packet_scene(rng, "soup", 1024)
    accel = build_accel(tris, n)
    o, d, alive = (torch.from_numpy(x) for x in packet_rays(rng, 4096, lo, hi))
    w, f = culling.program_union_words(o, d, alive, accel)
    run = lambda prec: pm.search_mxu_reference(o, d, w, f, accel.mxu_coeffs,
                                               accel.orig_idx, prec, alive)
    highest = run("highest")
    same = cs.mxu_contract(tris, o, d, alive, highest, highest)
    assert same["ok"] and same["over"] == 0 and same["hits"] > 1000
    control = cs.mxu_contract(tris, o, d, alive, run("split3"), highest)
    assert not control["ok"], cs.contract_note(control)
    assert control["graze"] > 0 and control["graze_over"] > 0, cs.contract_note(control)
