"""``torch.func.jacfwd`` and ``torch.func.vmap`` through a render.

``jacfwd`` is a ``vmap`` of ``jvp`` over the tangent directions. The
search wrappers run under ``ops/no_tangent.py``'s ``_NoTangent``, whose
``vmap`` rule calls the search once when no input carries the batch (under
``jacfwd`` only the tangents do) and once per element otherwise; the
integrator's live-lane loop keeps, under a batched mask, the lanes live in
any element and masks the others (``live_lanes``, ``lane_count``).

Held here on the CPU: the port's ``jacfwd`` of ``render`` by the camera
pose (origin and view direction, as ``fit_camera`` parameterises it) and a
few triangles' albedo against ``jax.jacfwd`` of JAX's render on the same
inputs, at the forward-mode tolerance of tests/test_torch_forward_mode.py
(``GRAD_RTOL[max_bounce]`` times the largest |entry|, here per parameter);
``jacfwd`` against the stack of one ``jvp`` per direction in every
integrator mode (bit for bit); the search called as often under ``jacfwd``
as in one render; ``vmap`` over cameras (on every search route, whose
culling prelude runs on the batched rays) and over scene leaves equal to
the separate renders bit for bit, counts per element; the ``vmap`` rule on a
plain search in both its branches, and the lane helpers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingc_tpu.camera import look_at_basis as j_look_at_basis
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu_torch.camera import Camera, look_at_basis
from raytracingc_tpu_torch.ops import search
from raytracingc_tpu_torch.ops import search_brute as brute_mod
from raytracingc_tpu_torch.ops.no_tangent import lane_count, live_lanes
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute
from raytracingc_tpu_torch.render.integrator import render_debug
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves
from test_torch_diff import GRAD_RTOL, demo  # noqa: F401  (fixture)
from test_torch_integrator_modes import scenes  # noqa: F401  (fixture)

W, H, SPP = 8, 8, 2
ROWS = [0, 2, 3]  # demo-scene triangles whose albedo is differentiated
MODES = {
    "production": dict(early_exit=True),
    "fast": dict(early_exit=False),
    "oracle": dict(early_exit=False, compact=False),
}
# Every mode of the integrator, the widened ones too.
ALL_MODES = {**MODES, "sample_group": dict(early_exit=True, sample_group="auto"),
             "sample_batch": dict(early_exit=True, sample_batch=2),
             "sample_batch_oracle": dict(early_exit=False, sample_batch=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(tc, ts) -> torch.Tensor:
    """[6 + 3 * len(ROWS)]: origin, view direction, the rows' albedo."""
    return torch.cat([tc.origin, tc.ez, ts.triangles.albedo[ROWS].reshape(-1)])


def _port_image(ts, tc, max_bounce, mode, size=(W, H)):
    rows = torch.tensor(ROWS)
    albedo = ts.triangles.albedo

    def image(p):
        x, y, z = p[3:6].unbind(-1)
        dn = p[3:6] / torch.sqrt(x * x + y * y + z * z)
        ex, ey, ez = look_at_basis(p[:3], p[:3] + dn)
        cam = Camera(origin=p[:3], ex=ex, ey=ey, ez=ez, fov=tc.fov)
        s = with_leaves(ts, {".triangles.albedo": albedo.index_copy(
            0, rows, p[6:].reshape(-1, 3))})
        return render(s, cam, *size, SPP, max_bounce, **mode)[0]
    return image


def _jax_image(js, jc, max_bounce, mode):
    def image(p):
        dn = p[3:6] / jnp.linalg.norm(p[3:6])
        ex, ey, ez = j_look_at_basis(p[:3], p[:3] + dn)
        cam = jc.replace(origin=p[:3], ex=ex, ey=ey, ez=ez)
        tris = js.triangles.replace(
            albedo=js.triangles.albedo.at[jnp.asarray(ROWS)].set(p[6:].reshape(-1, 3)))
        return j_render(js.replace(triangles=tris), cam, W, H, SPP, max_bounce,
                        **mode)[0]
    return image


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("max_bounce", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_jacfwd_matches_jax(demo, mode, max_bounce):  # noqa: F811
    js, ts, jc, tc = demo
    p = _params(tc, ts)
    want = np.asarray(jax.jacfwd(_jax_image(js, jc, max_bounce, MODES[mode]))(
        jnp.asarray(p.numpy())))
    got = torch.func.jacfwd(_port_image(ts, tc, max_bounce, MODES[mode]))(p).numpy()
    assert got.shape == want.shape == (H, W, 3, p.numel())
    moved = []
    for k in range(p.numel()):
        scale = float(np.abs(want[..., k]).max())
        np.testing.assert_allclose(got[..., k], want[..., k], rtol=0,
                                   atol=GRAD_RTOL[max_bounce] * scale, err_msg=str(k))
        moved.append(scale > 0)
    # The view direction moves every image. The origin (through the
    # sphere's normal at the hit point) and the rows' albedo (no emitter
    # among them) move it from the second bounce on: at the first, the
    # emission and the sky seen depend on the direction only.
    assert all(moved[3:6])
    assert moved[:3] + moved[6:] == [max_bounce > 1] * (p.numel() - 3)


@pytest.mark.parametrize("mode", list(ALL_MODES))
def test_jacfwd_equals_stacked_jvps(demo, mode):  # noqa: F811
    _, ts, _, tc = demo
    image = _port_image(ts, tc, 3, ALL_MODES[mode])
    p = _params(tc, ts)
    jac = torch.func.jacfwd(image)(p)
    cols = torch.stack([torch.func.jvp(image, (p,), (e,))[1]
                        for e in torch.eye(p.numel())], dim=-1)
    assert torch.equal(_bits(jac), _bits(cols))
    assert torch.equal(_bits(torch.func.jvp(image, (p,), (p,))[0]), _bits(image(p)))


def _count_searches(monkeypatch) -> list:
    calls = []
    plain = brute_mod.search_brute_reference

    def counted(*args):
        calls.append(args[0].shape[0])
        return plain(*args)

    monkeypatch.setattr(brute_mod, "search_brute_reference", counted)
    return calls


@pytest.mark.parametrize("mode", ["production", "oracle"])
def test_jacfwd_searches_as_one_render(scenes, monkeypatch, mode):  # noqa: F811
    """box_scene (10 triangles: the brute route, K1 on the card): jacfwd
    calls the search exactly as often, on as many rays, as one render: the
    rule did not loop over the tangent directions."""
    _, ts, _, tc = scenes
    calls = _count_searches(monkeypatch)
    p = torch.cat([tc.origin, tc.ez])
    image = lambda q: _port_image(ts, tc, 4, MODES[mode], size=(16, 12))(
        torch.cat([q, ts.triangles.albedo[ROWS].reshape(-1)]))
    image(p)
    one = list(calls)
    calls.clear()
    jac = torch.func.jacfwd(image)(p)
    assert calls == one and len(one) >= 4
    assert float(jac.abs().max()) > 0


def _poses(tc) -> torch.Tensor:
    base = torch.cat([tc.origin, tc.ez])
    return torch.stack([base, base + torch.tensor([0.3, -0.1, 0.2, 0.0, 0.05, 0.0]),
                        base + torch.tensor([-0.2, 0.1, 0.0, 0.04, 0.0, -0.03])])


@pytest.mark.parametrize("mode", list(ALL_MODES))
def test_vmap_over_cameras_equals_renders(scenes, mode):  # noqa: F811
    """Three cameras through one vmapped render (ragged pixel chunks): each
    image the separate render's bits, each count its int."""
    _, ts, _, tc = scenes

    def f(p):
        x, y, z = p[3:].unbind(-1)
        ex, ey, ez = look_at_basis(p[:3], p[:3] + p[3:] / torch.sqrt(x * x + y * y + z * z))
        img, n = render(ts, Camera(origin=p[:3], ex=ex, ey=ey, ez=ez, fov=tc.fov),
                        24, 20, 4, 4, seed=5, pixel_chunk=256, **ALL_MODES[mode])
        return img, torch.as_tensor(n)

    poses = _poses(tc)
    imgs, counts = torch.func.vmap(f)(poses)
    for k in range(3):
        img, n = f(poses[k])
        assert torch.equal(_bits(imgs[k]), _bits(img)), k
        assert int(counts[k]) == int(n), k
    assert len({int(c) for c in counts}) > 1  # the cameras' paths differ


# The accel routes, whose culling prelude (the per-packet words of
# culling.cull_words or the spans, stream_tile_pad) runs on the batched rays outside
# _NoTangent: box_scene tessellated, routed by the knobs as
# tests/test_torch_render_accel.py routes it (the bitmask route at
# --tessellate 5 with the default knobs, as chip_smoke.py's K2 case; the
# mxu route, whose plain version is the slowest on the CPU, at
# --tessellate 2; the others at --tessellate 4). (levels, knobs, the
# route's wrapper)
STREAMED = {"RTC_BRUTE_MAX": "0", "RTC_STREAM_MAX_T": "1024", "RTC_STREAM_TILE": "768"}
PACKET_ROUTES = {
    "bitmask": (5, {}, "search_bitmask"),
    "packed": (4, STREAMED, "search_packed"),
    "range": (4, {"RTC_BRUTE_MAX": "0", "RTC_CULL": "range"}, "search_range"),
    "words": (4, {**STREAMED, "RTC_STREAM_CULL": "words"}, "search_words"),
    "mxu": (2, {"RTC_KERNEL": "mxu"}, "search_mxu"),
}


@pytest.mark.parametrize("mode", ["production", "fast"])
@pytest.mark.parametrize("route", list(PACKET_ROUTES))
def test_vmap_over_cameras_on_packet_routes(scenes, monkeypatch, route, mode):  # noqa: F811
    """As test_vmap_over_cameras_equals_renders, through every accel
    route's plain version: each image the separate render's bits, each
    count its int, the route's search called."""
    _, ts, _, tc = scenes
    levels, env, name = PACKET_ROUTES[route]
    tt, n_tri = tb.tessellate(ts.triangles, ts.n_triangles, levels=levels)
    big = dataclasses.replace(ts, triangles=tt, n_triangles=n_tri,
                              accel=None).with_accel()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    real = getattr(search, name)
    monkeypatch.setattr(search, name, lambda *a, **k: (calls.append(1), real(*a, **k))[1])

    def f(p):
        x, y, z = p[3:].unbind(-1)
        ex, ey, ez = look_at_basis(p[:3], p[:3] + p[3:] / torch.sqrt(x * x + y * y + z * z))
        img, n = render(big, Camera(origin=p[:3], ex=ex, ey=ey, ez=ez, fov=tc.fov),
                        12, 10, 2, 3, seed=5, pixel_chunk=64, **MODES[mode])
        return img, torch.as_tensor(n)

    poses = _poses(tc)
    imgs, counts = torch.func.vmap(f)(poses)
    assert calls
    for k in range(3):
        img, n = f(poses[k])
        assert torch.equal(_bits(imgs[k]), _bits(img)), k
        assert int(counts[k]) == int(n), k
    assert len({int(c) for c in counts}) > 1


def test_vmap_over_scene_leaves_and_debug(scenes):  # noqa: F811
    """vmap over three albedo tables (the live lanes differ through the
    roulette) and over cameras through the bounce heatmap."""
    _, ts, _, tc = scenes
    albedo = ts.triangles.albedo
    tables = torch.stack([albedo, albedo * 0.5, albedo.flip(0)])

    def f(a):
        img, n = render(with_leaves(ts, {".triangles.albedo": a}), tc, 16, 16, 4, 5,
                        seed=1)
        return img, torch.as_tensor(n)

    imgs, counts = torch.func.vmap(f)(tables)
    for k in range(3):
        img, n = f(tables[k])
        assert torch.equal(_bits(imgs[k]), _bits(img)) and int(counts[k]) == int(n)
    assert len({int(c) for c in counts}) > 1

    def g(p):
        cam = dataclasses.replace(tc, origin=p)
        return render_debug(ts, cam, 16, 16, 5, seed=2)

    origins = _poses(tc)[:, :3]
    heat = torch.func.vmap(g)(origins)
    for k in range(3):
        assert torch.equal(heat[k], g(origins[k])), k


def test_no_tangent_vmap_rule(scenes, monkeypatch):  # noqa: F811
    """The rule on a plain search (search_brute on the CPU): with no input
    batched it runs once, unbatched; with a batched input, once per
    element, each element its own call's bits (both outputs, either batch
    dimension). The lane helpers: the union of the elements' lanes, and
    per-element counts."""
    _, ts, _, _ = scenes
    rs = np.random.default_rng(4)
    o = torch.from_numpy(rs.uniform(-4, 1, (64, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rs.normal(size=(64, 3)).astype(np.float32)), dim=1)
    n = ts.n_triangles
    tri = pack_triangles(ts.triangles, n)
    calls = _count_searches(monkeypatch)
    dst, idx = search_brute(o, d, tri, n)
    assert (idx >= 0).any() and (idx < 0).any()
    calls.clear()

    out = torch.func.vmap(lambda t: search_brute(o, d, tri, n)[0] + t)(torch.zeros(3))
    assert len(calls) == 1
    for k in range(3):
        assert torch.equal(_bits(out[k]), _bits(dst))

    calls.clear()
    batch = torch.stack([o, o + 0.25, o - 0.5])
    b_dst, b_idx = torch.func.vmap(lambda x: search_brute(x, d, tri, n))(batch)
    assert len(calls) == 3
    for k in range(3):
        w_dst, w_idx = search_brute(batch[k], d, tri, n)
        assert torch.equal(_bits(b_dst[k]), _bits(w_dst)) and torch.equal(b_idx[k], w_idx)
    c_dst, _ = torch.func.vmap(lambda x: search_brute(o, x, tri, n), in_dims=1)(
        torch.stack([d, -d], dim=1))
    assert torch.equal(_bits(c_dst[1]), _bits(search_brute(o, -d, tri, n)[0]))

    m = torch.tensor([[True, False, False, True, False],
                      [False, False, True, True, False]])
    lanes, union = live_lanes(m[0])
    assert lanes.tolist() == [0, 3] and union is False and lane_count(m[0]) == 2
    seen = []

    def lanes_of(x):
        ix, u = live_lanes(x)
        seen.append(u)
        return ix

    assert torch.func.vmap(lanes_of)(m).tolist() == [[0, 2, 3]] * 2 and seen == [True]
    assert torch.func.vmap(lambda x: lane_count(x[:3]))(m).tolist() == [1, 1]
    assert torch.func.vmap(lane_count)(m).tolist() == [2, 2]
