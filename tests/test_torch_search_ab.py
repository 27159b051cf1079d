"""Port parity: the A/B culling routes, range (K4, K5) and words (K6, K7),
and the dispatch of every route (K1-K8).

The port's dispatch (``ops/search.py``) on CPU tensors runs each kernel's
plain version (``ops/search_range.py``, ``ops/search_words.py``); it is held
against the JAX package's dispatch with the Pallas kernels in interpret
mode, on a 1,800-triangle soup through every range and words branch.
Winning indices must be EQUAL on every lane, dead lanes included; distances
agree to rtol 1e-6 with atol 1e-5 (XLA:CPU contracts multiply-adds into FMA
and the port does not, ROADMAP Queue 3 P1); live lanes win the same
triangles as the port's brute scan. On a scene of duplicated triangles,
whose exact distance ties cross tiles, every route picks the lowest original
index, as the C-order scan does. The port's ``route()`` names the kernel the
JAX package launches over the whole matrix of cull knobs and scene sizes,
``RTC_KERNEL=mxu`` included, and CPU renders through every A/B route equal
the default route's bit for bit.
"""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingc_tpu.ops.intersect_mxu as jm
import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu.ops.intersect import _search_triangles_xla
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch.cli import main
from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops.accel import build_accel
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute_reference
from raytracingc_tpu_torch.ops.search_range import search_range, search_range_reference
from raytracingc_tpu_torch.ops.search_words import search_words, search_words_reference
from raytracingc_tpu_torch.render.image import read_bmp
from test_torch_accel import port_tris, soup
from test_torch_search_packet import KNOBS, rays_at

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
TINY_STREAM = {"RTC_STREAM_MAX_T": "256", "RTC_STREAM_TILE": "256"}
PORT_KERNELS = ("search_brute", "search_bitmask", "search_packed",
                "search_range", "search_words", "search_mxu")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _set(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture
def port_spies(monkeypatch):
    """Names of the port's kernel wrappers that a search called."""
    calls = []
    for name in PORT_KERNELS:
        real = getattr(search, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(search, name, spy)
    return calls


# (name, env, port kernel, TPU kernel)
BRANCHES = [
    ("K4_cull_range", {"RTC_CULL": "range", "RTC_KERNEL": "packet"}, "range", "K4"),
    ("K4_stream_cull_range", {"RTC_STREAM_CULL": "range",
                              "RTC_BITMASK_MAX_WORDS": "0"}, "range", "K4"),
    ("K5_tile256", {"RTC_CULL": "range", **TINY_STREAM}, "range", "K5"),
    ("K5_tile512_ragged", {"RTC_CULL": "range", "RTC_STREAM_MAX_T": "256",
                           "RTC_STREAM_TILE": "512"}, "range", "K5"),
    ("K6_resident", {"RTC_STREAM_CULL": "words", "RTC_BITMASK_MAX_WORDS": "0"},
     "words", "K6"),
    ("K6_streamed_ray", {"RTC_STREAM_CULL": "words", "RTC_STREAM_ORDER": "ray",
                         **TINY_STREAM}, "words", "K6"),
    ("K7_streamed", {"RTC_STREAM_CULL": "words", **TINY_STREAM}, "words", "K7"),
]


@pytest.mark.parametrize("name,env,kernel,tpu", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_ab_search_matches_interpret_pallas(name, env, kernel, tpu, monkeypatch,
                                            port_spies):
    _set(monkeypatch, env)
    jtris, n = soup(1800, seed=21)  # 1,920 padded = 15 blocks
    o, d, alive = rays_at(1003, seed=22)  # ragged: 125 packets + 3 rays
    jd, ji = (np.asarray(x) for x in ip.search_triangles_pallas(
        jnp.asarray(o), jnp.asarray(d), jtris, interpret=True,
        alive=jnp.asarray(alive), accel=j_build_accel(jtris, n), n_live=n))

    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    way = search.route(n, accel.n_blocks, search.Knobs.read())
    assert (way.kernel, way.tpu) == (kernel, tpu)
    pd, pi = search.search_triangles(to, td, tris, n, alive=ta, accel=accel)
    assert port_spies == [f"search_{kernel}"]
    pd, pi = pd.numpy(), pi.numpy()

    np.testing.assert_array_equal(pi, ji)  # every lane, dead ones included
    np.testing.assert_allclose(pd, jd, rtol=1e-6, atol=1e-5)
    bd, bi = search_brute_reference(to, td, pack_triangles(tris, n), n, ta)
    np.testing.assert_array_equal(pi[alive], bi.numpy()[alive])
    assert (pi[alive] >= 0).sum() > 100  # the comparison is not vacuous
    assert ((pi >= 0) & ~alive).sum() > 10  # dead lanes are not masked


def test_plain_versions_direct():
    """The wrappers' CPU path IS the plain version. The range kernel gives
    the same bits on the resident plane (K4) and the tile-padded plane (K5);
    the words kernel the same bits at any tiling whose granule it is given,
    and its live lanes equal the range kernel's."""
    jtris, n = soup(1700, seed=23)  # 1,792 padded = 14 blocks
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    o, d, alive = rays_at(517, seed=24)
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    plane, oi = accel.packed_plane, accel.orig_idx

    first, last = culling.packet_block_ranges(to, td, ta, accel)
    k4 = search_range(to, td, first, last, plane, oi)
    assert all(torch.equal(a, b) for a, b in zip(
        k4, search_range_reference(to, td, first, last, plane, oi)))
    plane_t, oi_t = culling.stream_tile_pad(plane, oi, 640)  # 3 tiles, ragged
    k5 = search_range(to, td, first, last, plane_t, oi_t)
    assert all(torch.equal(a, b) for a, b in zip(k4, k5))
    # A span past the plane is clipped to it, and (2**30, -1) tests nothing.
    wide = search_range(to, td, torch.zeros_like(first), torch.full_like(last, 99),
                        plane, oi)
    bd, bi = search_brute_reference(to, td, pack_triangles(tris, n), n)
    assert torch.equal(wide[1], bi)
    none = search_range(to, td, torch.full_like(first, 2**30),
                        torch.full_like(last, -1), plane, oi)
    assert (none[1] == -1).all()

    for tile, n_tiles in ((1792, 1), (640, 3), (256, 7)):
        bpt = tile // 128
        g = -(-bpt // 31)
        w = culling.packet_tile_words(to, td, ta, accel, n_tiles, bpt, g)
        pt, ot = culling.stream_tile_pad(plane, oi, tile)
        kw = search_words(to, td, w, pt, ot, tile, g)
        assert all(torch.equal(a, b) for a, b in zip(
            kw, search_words_reference(to, td, w, pt, ot, tile, g)))
        assert torch.equal(kw[1][ta], k4[1][ta])
        assert torch.equal(kw[0][ta], k4[0][ta])
    assert (k4[1][ta] >= 0).sum() > 50


def test_ab_wrappers_validate():
    jtris, n = soup(300, seed=1)
    accel = build_accel(port_tris(jtris), n)
    o = torch.zeros((16, 3))
    d = torch.ones((16, 3))
    plane, oi = accel.packed_plane, accel.orig_idx
    f = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="first"):
        search_range(o, d, f[:1], f, plane, oi)
    with pytest.raises(ValueError, match="last"):
        search_range(o, d, f, f.long(), plane, oi)
    with pytest.raises(RuntimeError, match="no kernel"):
        search_range(o.to("meta"), d.to("meta"), f.to("meta"), f.to("meta"),
                     plane.to("meta"), oi.to("meta"))
    w = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="words"):
        search_words(o, d, w[:, :, None], plane, oi, 128, 1)
    with pytest.raises(ValueError, match="tile"):
        search_words(o, d, w, plane, oi, 256, 1)
    with pytest.raises(ValueError, match="granule"):
        search_words(o, d, w, plane, oi, 128, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        search_words(o.to("meta"), d.to("meta"), w.to("meta"), plane.to("meta"),
                     oi.to("meta"), 128, 1)
    dst, idx = search_words(o, d, w, plane, oi, 128, 1)  # no bits: all miss
    assert (idx == -1).all() and (dst == 999999.0).all()


@pytest.fixture(scope="module")
def dup_scene():
    """600 random triangles plus copies of the first 300 at the tail: exact
    distance ties between ORIGINAL indices far apart, which the Morton sort
    scatters over blocks and tiles (1,024 padded = 8 blocks). The oracle is
    the JAX package's C-order scan."""
    rng = np.random.default_rng(41)
    a = rng.uniform(-3, 3, (600, 3)).astype(np.float32)
    b = a + rng.uniform(-0.5, 0.5, (600, 3)).astype(np.float32)
    c = a + rng.uniform(-0.5, 0.5, (600, 3)).astype(np.float32)
    a, b, c = (np.concatenate([x, x[:300]]) for x in (a, b, c))
    nrm = np.cross(b - a, c - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    jtris, n = jb.triangles_from_arrays(
        np.stack([a, b, c], 1), nrm, np.full((900, 3), 0.5, np.float32),
        np.zeros(900, np.float32), np.zeros(900, np.float32))
    rs = np.random.default_rng(42)
    o = rs.uniform(-5, 5, (2048, 3)).astype(np.float32)
    d = rs.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xd, xi = (np.asarray(x) for x in _search_triangles_xla(
        jnp.asarray(o), jnp.asarray(d), jtris))
    return port_tris(jtris), n, o, d, xd, xi


TIE_ROUTES = [
    ("K4", {"RTC_CULL": "range"}),
    ("K5", {"RTC_CULL": "range", **TINY_STREAM}),
    ("K6", {"RTC_STREAM_CULL": "words", "RTC_BITMASK_MAX_WORDS": "0"}),
    ("K6", {"RTC_STREAM_CULL": "words", "RTC_STREAM_ORDER": "ray", **TINY_STREAM}),
    ("K7", {"RTC_STREAM_CULL": "words", **TINY_STREAM}),
]


@pytest.mark.parametrize("tpu,env", TIE_ROUTES,
                         ids=["K4", "K5", "K6_resident", "K6_streamed", "K7"])
def test_cross_tile_ties_take_the_lowest_original_index(tpu, env, dup_scene,
                                                        monkeypatch):
    tris, n, o, d, xd, xi = dup_scene
    _set(monkeypatch, {"RTC_BRUTE_MAX": "0", **env})
    accel = build_accel(tris, n)
    way = search.route(n, accel.n_blocks, search.Knobs.read())
    assert way.tpu == tpu and (way.n_tiles == 4) == ("RTC_STREAM_MAX_T" in env)
    pd, pi = search.search_triangles(torch.from_numpy(o), torch.from_numpy(d),
                                     tris, n, accel=accel)
    np.testing.assert_array_equal(pi.numpy(), xi)
    np.testing.assert_allclose(pd.numpy(), xd, rtol=1e-6, atol=1e-5)
    # A ray that hits one of the first 300 triangles hits its copy (600
    # later) at the same distance, and the original must win: no winner is a
    # copy, and many are originals with a copy.
    assert xi.max() < 600 and ((xi >= 0) & (xi < 300)).sum() > 50


# The JAX launchers, and the TPU kernel each one runs. The MXU launcher is
# imported from its module inside search_triangles_pallas, so it is patched
# there.
JAX_LAUNCHERS = {
    "_search_padded_brute": "K1",
    "_search_padded_bitmask": "K2",
    "_search_padded_streamed_packed_tmajor": "K3",
    "_search_padded": "K4",
    "_search_padded_streamed": "K5",
    "_search_padded_streamed_words": "K6",
    "_search_padded_streamed_words_tmajor": "K7",
    "_search_padded_mxu": "K8",
}
SIZES = {  # (live triangles, knobs)
    "brute_size": (300, {}),
    "fits": (1800, {}),
    "past_word_cap": (1800, {"RTC_BITMASK_MAX_WORDS": "0"}),
    "streamed": (1800, {"RTC_STREAM_MAX_T": "1024", "RTC_STREAM_TILE": "768"}),
    "past_mxu_cap": (8300, {}),  # 8,320 padded
}


@pytest.fixture
def jax_spies(monkeypatch):
    """Replace the JAX launchers with spies that record (TPU kernel, tile,
    granule) and return misses: no Pallas kernel runs."""
    calls = []
    for name, tpu in JAX_LAUNCHERS.items():
        def spy(*args, _tpu=tpu, **kw):
            calls.append((_tpu, kw.get("tile"), kw.get("granule")))
            n_cols = next(a for a in args if getattr(a, "ndim", 0) == 3).shape[2]
            return (jnp.full((8, n_cols), 999999.0, jnp.float32),
                    jnp.full((8, n_cols), -1, jnp.int32))

        monkeypatch.setattr(jm if name == "_search_padded_mxu" else ip, name, spy)
    return calls


@pytest.mark.parametrize("size", [s for s in SIZES if s != "past_mxu_cap"])
@pytest.mark.parametrize("stream_cull", [None, "packed", "words", "range"])
@pytest.mark.parametrize("cull", [None, "bitmask", "range"])
def test_route_matrix_matches_jax(cull, stream_cull, size, jax_spies, port_spies,
                                  monkeypatch):
    n_tris, env = SIZES[size]
    jtris, n = soup(n_tris, seed=3)
    ja = j_build_accel(jtris, n)
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    o, d, _ = rays_at(64, seed=31)
    _set(monkeypatch, env)
    if cull:
        monkeypatch.setenv("RTC_CULL", cull)
    if stream_cull:
        monkeypatch.setenv("RTC_STREAM_CULL", stream_cull)
    for order in (None, "tile", "ray"):
        if order:
            monkeypatch.setenv("RTC_STREAM_ORDER", order)
        jax_spies.clear()
        port_spies.clear()
        ip.search_triangles_pallas(jnp.asarray(o), jnp.asarray(d), jtris,
                                   interpret=True, accel=ja, n_live=n)
        way = search.route(n, accel.n_blocks, search.Knobs.read())
        tiled = way.kernel in ("packed", "words", "range") and way.tpu != "K4"
        want = (way.tpu, way.tile if tiled else None,
                way.granule if way.kernel in ("packed", "words") else None)
        assert jax_spies == [want], (order, way)
        search.search_triangles(torch.from_numpy(o), torch.from_numpy(d), tris,
                                n, accel=accel)
        assert port_spies == [f"search_{way.kernel}"], (order, way)


@pytest.mark.parametrize("size", ["brute_size", "fits", "past_mxu_cap"])
@pytest.mark.parametrize("cull", [None, "range"])
def test_mxu_route_matches_jax(cull, size, jax_spies, port_spies, monkeypatch,
                               capsys):
    """RTC_KERNEL=mxu takes K8 at any scene size up to the cap (the brute
    rule does not apply) and past it prints the JAX package's notice and
    takes the packet route, on both sides."""
    n_tris, env = SIZES[size]
    jtris, n = soup(n_tris, seed=3)
    ja = j_build_accel(jtris, n)
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    o, d, _ = rays_at(64, seed=31)
    _set(monkeypatch, {**env, "RTC_KERNEL": "mxu"})
    if cull:
        monkeypatch.setenv("RTC_CULL", cull)
    ip.search_triangles_pallas(jnp.asarray(o), jnp.asarray(d), jtris,
                               interpret=True, accel=ja, n_live=n)
    jax_err = capsys.readouterr().err
    way = search.route(n, accel.n_blocks, search.Knobs.read())
    assert [c[0] for c in jax_spies] == [way.tpu]
    assert (way.tpu == "K8") == (size != "past_mxu_cap")
    search.search_triangles(torch.from_numpy(o), torch.from_numpy(d), tris, n,
                            accel=accel)
    assert port_spies == [f"search_{way.kernel}"]
    port_err = capsys.readouterr().err
    notice = "RTC_KERNEL=mxu unsupported at 8320 padded triangles (cap 8192)"
    assert (notice in jax_err) == (notice in port_err) == (size == "past_mxu_cap")


ROUTE_ENVS = {
    "brute": {"RTC_KERNEL": "brute"},
    "mxu": {"RTC_KERNEL": "mxu"},
    "bitmask": {},
    "packed": {"RTC_BITMASK_MAX_WORDS": "0"},
    "range": {"RTC_CULL": "range"},
    "words": {"RTC_STREAM_CULL": "words", "RTC_BITMASK_MAX_WORDS": "0"},
}


@pytest.mark.parametrize("typo", [("RTC_STREAM_ORDER", "tiles"), ("RTC_EXTRACT", "rolll"),
                                  ("RTC_MXU_PRECISION", "split")],
                         ids=["order", "extract", "mxu_precision"])
@pytest.mark.parametrize("kernel", list(ROUTE_ENVS))
def test_knob_typos_raise_on_every_route(kernel, typo, monkeypatch, port_spies):
    jtris, n = soup(1800, seed=21)
    tris = port_tris(jtris)
    accel = build_accel(tris, n)
    o, d, _ = (torch.from_numpy(x) for x in rays_at(16, seed=0))
    _set(monkeypatch, ROUTE_ENVS[kernel])
    search.search_triangles(o, d, tris, n, accel=accel)
    assert port_spies == [f"search_{kernel}"]
    monkeypatch.setenv(*typo)
    with pytest.raises(ValueError, match=typo[0]):
        search.search_triangles(o, d, tris, n, accel=accel)
    assert port_spies == [f"search_{kernel}"]


def test_only_mxu_is_not_ported(monkeypatch, port_spies):
    """Nothing is left unported: RTC_KERNEL=mxu routes to K8 (search_mxu),
    and no value of any choice knob raises NotImplementedError."""
    o, d, _ = (torch.from_numpy(x) for x in rays_at(16, seed=0))
    jtris, n = soup(1800, seed=21)
    tris = port_tris(jtris)
    monkeypatch.setenv("RTC_KERNEL", "mxu")
    assert search.route(n, 15, search.Knobs.read()) == search.Route("mxu", "K8")
    search.search_triangles(o, d, tris, n)  # the trivial accel packs its table
    assert port_spies == ["search_mxu"]
    assert not hasattr(search, "_NOT_PORTED")
    for name, values in search._CHOICES.items():
        for value in values:
            monkeypatch.setenv(name, value)
            search.Knobs.read()
        monkeypatch.delenv(name)


def _cli(argv, env):
    """Run the port CLI on the CPU under ``env``: ``(image, traced rays,
    kernels launched)``."""
    calls = set()
    with pytest.MonkeyPatch.context() as m:
        for k in KNOBS:
            m.delenv(k, raising=False)
        _set(m, env)
        for name in PORT_KERNELS:
            real = getattr(search, name)

            def spy(*a, _real=real, _name=name, **k):
                calls.add(_name)
                return _real(*a, **k)

            m.setattr(search, name, spy)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + ["--device", "cpu", "--profile"]) == 0
    rays = int(re.search(r"rays=(\d+)", buf.getvalue()).group(1))
    return read_bmp(argv[argv.index("-o") + 1]), rays, calls


@pytest.fixture(scope="module")
def one_torch_thread():
    """As in test_torch_render.py: parity renders run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_range_cull_renders_on_the_brute_route(tmp_path, one_torch_thread):
    """RTC_CULL=range keeps the brute route on a brute-size scene, as the
    JAX package does: the render is byte-equal to the default one."""
    argv = ["--triangles", BOX_SCENE, "-s", "16", "16", "--spp", "4", "-b", "3"]
    img, rays, calls = _cli(argv + ["-o", str(tmp_path / "d.bmp")], {})
    got, got_rays, got_calls = _cli(argv + ["-o", str(tmp_path / "r.bmp")],
                                    {"RTC_CULL": "range"})
    assert calls == got_calls == {"search_brute"}
    assert (tmp_path / "d.bmp").read_bytes() == (tmp_path / "r.bmp").read_bytes()
    assert got_rays == rays > 500 and np.array_equal(got, img)


AB_TESSELLATED = ["--triangles", BOX_SCENE, "--tessellate", "4", "-s", "16", "16",
                  "--spp", "2", "-b", "3"]
SMALL_STREAM = {"RTC_STREAM_MAX_T": "1024", "RTC_STREAM_TILE": "768"}
AB_ROUTES = {  # (env, port kernel)
    "K4": ({"RTC_CULL": "range"}, "search_range"),
    "K5": ({"RTC_CULL": "range", **SMALL_STREAM}, "search_range"),
    "K6_resident": ({"RTC_STREAM_CULL": "words", "RTC_BITMASK_MAX_WORDS": "0"},
                    "search_words"),
    "K6_streamed": ({"RTC_STREAM_CULL": "words", "RTC_STREAM_ORDER": "ray",
                     **SMALL_STREAM}, "search_words"),
    "K7": ({"RTC_STREAM_CULL": "words", **SMALL_STREAM}, "search_words"),
}


@pytest.fixture(scope="module")
def default_tessellated(tmp_path_factory, one_torch_thread):
    path = tmp_path_factory.mktemp("ab") / "default.bmp"
    img, rays, calls = _cli(AB_TESSELLATED + ["-o", str(path)], {})
    assert calls == {"search_bitmask"}  # 2,560 triangles: 20 blocks
    return path.read_bytes(), img, rays


@pytest.mark.parametrize("route", list(AB_ROUTES))
def test_cli_ab_routes_render_the_same(route, default_tessellated, tmp_path):
    env, kernel = AB_ROUTES[route]
    want_bytes, want, want_rays = default_tessellated
    path = tmp_path / f"{route}.bmp"
    img, rays, calls = _cli(AB_TESSELLATED + ["-o", str(path)], env)
    assert calls == {kernel}
    assert path.read_bytes() == want_bytes
    assert rays == want_rays > 500 and np.array_equal(img, want)
