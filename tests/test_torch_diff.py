"""Port parity: gradients, the refreshed accel, FD checks and inverse rendering.

The same scene (``__graft_entry__._demo_scene`` and seeded soups, carried
across with the numpy bridge) goes through ``jax.grad`` of the JAX
integrator (on the CPU, its reference search) and through autograd of the
port's differentiable fast forward; gradients compare leaf by leaf under
the JAX package's ``keystr`` names (``bridge.leaf_arrays``).

Tolerances, relative to the leaf's largest |gradient|: 2e-5 at one bounce
(the bounce-0 light: emission and environment, where XLA's and torch's
``pow`` differ by an ulp, amplified by the sun's exponent 22), 1e-4 at two
(the continuation adds Box-Muller directions whose log/cos round
differently in the two packages). Observed: 7e-6 and 7e-6.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.camera import primary_rays as j_primary_rays
from raytracingc_tpu.diff import optimize as j_optimize
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu.ops.accel import refresh_accel as j_refresh_accel
from raytracingc_tpu.render.integrator import trace_accumulate as j_trace
from raytracingc_tpu.scene.builder import pad_spheres, triangles_from_arrays
from raytracingc_tpu.scene.types import Scene as JScene
from raytracingc_tpu.scene.types import Spheres as JSpheres
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.camera import primary_rays
from raytracingc_tpu_torch.diff import (
    fd_check,
    fit_camera,
    fit_scene,
    is_geometry_trained,
    leaf_filter,
    pixel_grad_check,
)
from raytracingc_tpu_torch.ops import search
from raytracingc_tpu_torch.ops.accel import build_accel, refresh_accel, trivial_accel
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.types import LEAF_PATHS, scene_leaves, with_leaves
from test_torch_accel import assert_accels_equal

GRAD_RTOL = {1: 2e-5, 2: 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_scene(js):
    return bridge.scene_from_numpy(
        {f: np.asarray(getattr(js.triangles, f)) for f in bridge.TRIANGLE_FIELDS},
        {f: np.asarray(getattr(js.spheres, f)) for f in bridge.SPHERE_FIELDS},
        {f: np.asarray(getattr(js.env, f)) for f in bridge.ENV_FIELDS},
        js.n_triangles, js.n_spheres,
    )


@pytest.fixture(scope="module")
def demo():
    """The JAX demo scene (its albedos have tied channels: (1, 1, 1) and
    (0.9, 0.9, 0.9)) and the default camera, in both packages."""
    from __graft_entry__ import _demo_scene

    js = _demo_scene()
    jc = JCamera.look_at()
    tc = bridge.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in bridge.CAMERA_FIELDS})
    return js, port_scene(js), jc, tc


@pytest.fixture(scope="module")
def untied(demo):
    """The demo scene with its albedo ties broken, as tests/test_diff.py's
    fixture does (the roulette renorm a / max(a) has a kink at a tie, where
    FD straddles it and autodiff takes one side)."""
    js = demo[0]
    jt = jax.random.uniform(jax.random.PRNGKey(3), js.triangles.albedo.shape,
                            minval=-0.03, maxval=0.03)
    jsph = jax.random.uniform(jax.random.PRNGKey(4), js.spheres.albedo.shape,
                              minval=-0.03, maxval=0.03)
    js = js.replace(
        triangles=js.triangles.replace(
            albedo=jnp.clip(js.triangles.albedo + jt, 0.05, 0.97)),
        spheres=js.spheres.replace(
            albedo=jnp.clip(js.spheres.albedo + jsph, 0.05, 0.97)),
    )
    return js, port_scene(js)


@pytest.mark.parametrize("max_bounce", [1, 2])
def test_gradients_match_jax(demo, max_bounce):
    js, ts, jc, tc = demo
    w, h = 8, 8
    wts = np.random.default_rng(0).standard_normal((w * h, 3)).astype(np.float32)
    o, d = j_primary_rays(jc, w, h)
    ids = jnp.arange(w * h, dtype=jnp.uint32)

    def j_loss(s):
        rad, _ = j_trace(o, d, s, ids, seed=0, spp=2, max_bounce=max_bounce)
        return jnp.mean(rad * jnp.asarray(wts))

    j_val, j_grad = jax.value_and_grad(j_loss)(js)
    want = bridge.leaf_arrays(j_grad)

    leaves = {k: t.clone().requires_grad_(True) for k, t in scene_leaves(ts).items()}
    to, td = primary_rays(tc, w, h)
    rad, _ = trace_accumulate(to, td, with_leaves(ts, leaves), torch.arange(w * h),
                              seed=0, spp=2, max_bounce=max_bounce)
    loss = (rad * torch.from_numpy(wts)).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-6)
    assert list(want) == list(LEAF_PATHS)
    nonzero = 0
    for name, t in leaves.items():
        g = np.zeros(want[name].shape, np.float32) if t.grad is None else t.grad.numpy()
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(g, want[name], rtol=0,
                                   atol=GRAD_RTOL[max_bounce] * scale, err_msg=name)
        nonzero += scale > 0
    assert nonzero >= (7 if max_bounce == 1 else 13)


def _soup(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    b = a + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    c = a + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    nrm = np.cross(b - a, c - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    tris, n_live = triangles_from_arrays(
        np.stack([a, b, c], 1), nrm, np.full((n, 3), 0.5, np.float32),
        np.zeros(n, np.float32), np.zeros(n, np.float32),
    )
    spheres, _ = pad_spheres(JSpheres.empty(), pad_to=8)  # 8 padding rows
    return JScene.build(triangles=tris, spheres=spheres).replace(n_spheres=0), n_live


def _port_tris(jtris):
    from raytracingc_tpu_torch.scene.types import Triangles

    return Triangles(**{f: torch.from_numpy(np.array(getattr(jtris, f)))
                        for f in bridge.TRIANGLE_FIELDS})


@pytest.mark.parametrize("n", [256, 300])  # 300 pads to 384: padding slots
def test_refresh_matches_build_and_jax(n):
    js, n_live = _soup(n)
    tris = _port_tris(js.triangles)
    acc = build_accel(tris, n_live)
    got = refresh_accel(acc, tris, n_live)
    assert got.mxu_coeffs is None
    assert_accels_equal(got, j_refresh_accel(j_build_accel(js.triangles, n_live),
                                             js.triangles, n_live))
    for f in ("aabb_lo", "aabb_hi", "packed_plane", "orig_idx", "perm_of_orig"):
        assert torch.equal(getattr(got, f), getattr(acc, f)), f
    for f in bridge.TRIANGLE_FIELDS:
        assert torch.equal(getattr(got.triangles, f), getattr(acc.triangles, f)), f
    with pytest.raises(ValueError, match="trivial"):
        refresh_accel(trivial_accel(tris), tris, n_live)


def test_refreshed_accel_search_exact_after_moves(monkeypatch):
    """Move every vertex (jitter plus a +10 x translation out of every old
    block AABB), refresh on the old order: the packet route's search equals
    the brute scan bit for bit; the stale bounds would not."""
    js, n_live = _soup(1000, seed=3)  # 1,024 rows, 8 blocks
    tris = _port_tris(js.triangles)
    acc = build_accel(tris, n_live)
    rng = np.random.default_rng(7)
    delta = torch.from_numpy(rng.uniform(-1.0, 1.0, (tris.count, 3)).astype(np.float32)
                             + np.array([10.0, 0.0, 0.0], np.float32))
    moved = type(tris)(**{**{f: getattr(tris, f) for f in bridge.TRIANGLE_FIELDS},
                          "a": tris.a + delta, "b": tris.b + delta, "c": tris.c + delta})
    fresh = refresh_accel(acc, moved, n_live)
    o = torch.from_numpy(rng.uniform(-5, 5, (512, 3)).astype(np.float32)) \
        + torch.tensor([10.0, 0.0, 0.0])
    d = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    monkeypatch.setenv("RTC_KERNEL", "packet")
    got = search.search_triangles(o, d, moved, n_live, accel=fresh)
    monkeypatch.setenv("RTC_KERNEL", "brute")
    want = search.search_triangles(o, d, moved, n_live)
    assert torch.equal(got[1], want[1]) and (got[1] >= 0).sum() > 20
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    import dataclasses

    stale = dataclasses.replace(acc, triangles=fresh.triangles,
                                packed_plane=fresh.packed_plane)
    monkeypatch.setenv("RTC_KERNEL", "packet")
    bad = search.search_triangles(o, d, moved, n_live, accel=stale)
    assert not torch.equal(bad[0], want[0])


def test_refreshed_accel_gradients_match_accel_free():
    """The search is under no_grad on either side, so a loss through the
    refreshed accel has the accel-free oracle's value and gradients."""
    js, _ = _soup(300, seed=5)
    ts = port_scene(js)
    acc = build_accel(ts.triangles, ts.n_triangles)
    cam = bridge.camera_from_numpy(
        {f: np.asarray(getattr(JCamera.look_at(), f)) for f in bridge.CAMERA_FIELDS})
    o, d = primary_rays(cam, 8, 8)

    def loss(with_accel):
        leaves = {k: t.clone().requires_grad_(True)
                  for k, t in scene_leaves(ts).items()}
        s = with_leaves(ts, leaves)
        a = refresh_accel(acc, s.triangles, s.n_triangles) if with_accel else None
        import dataclasses

        rad, _ = trace_accumulate(o, d, dataclasses.replace(s, accel=a),
                                  torch.arange(64), seed=0, spp=2, max_bounce=2)
        val = (rad ** 2).mean()
        val.backward()
        return val, leaves

    l1, g1 = loss(True)
    l2, g2 = loss(False)
    assert l1.item() == l2.item()
    for f in (".triangles.a", ".triangles.b", ".triangles.c", ".triangles.albedo"):
        a, b = g1[f].grad, g2[f].grad
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_adam_step_matches_optax():
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    opt = optax.adam(1e-2)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([tp], lr=1e-2)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = jp + upd
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def test_fit_albedo_recovers(demo):
    """tests/test_diff.py::test_fit_albedo_recovers on the port: perturb the
    triangles' albedo, fit it back; loss halves, only albedo moves, and it
    moves toward the truth."""
    _, ts, _, tc = demo
    target, _ = render(ts, tc, 8, 8, 4, 2, seed=5)
    truth = ts.triangles.albedo
    leaves = scene_leaves(ts)
    leaves[".triangles.albedo"] = (truth * 0.4).clamp(0.0, 1.0)
    perturbed = with_leaves(ts, leaves)
    fitted, losses = fit_scene(perturbed, target, tc, steps=60, learning_rate=1e-1,
                               spp=4, max_bounce=2, seed=5, trainable=["albedo"])
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert torch.equal(fitted.triangles.a, perturbed.triangles.a)
    assert torch.equal(fitted.env.ground, perturbed.env.ground)
    before = (perturbed.triangles.albedo - truth).abs().sum()
    after = (fitted.triangles.albedo - truth).abs().sum()
    assert after < before


def test_fit_scene_geometry_refreshes_accel(monkeypatch):
    """Geometry training on a scene with a host-built accel: every step
    searches an accel refreshed from the current triangles (the face
    normals move here: vertex positions carry no gradient in this diffuse
    scene, examples/inverse_vertices.py), and refreshes it again after the
    update for the scene the step returns (make_train_step's two refreshes,
    as the JAX step's), which the next step searches as it is: 2 + 1
    refreshes, then 2 after the rebuild at step 2. The losses stay finite,
    and the fitted scene carries an accel rebuilt for its geometry."""
    import dataclasses

    from raytracingc_tpu_torch.parallel import sharded
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt, tessellate

    box = scene_from_triangles_txt("examples/box_scene.txt")
    tris, n = tessellate(box.triangles, box.n_triangles, levels=3)  # 640, 5 blocks
    s = dataclasses.replace(box, triangles=tris, n_triangles=n, accel=None).with_accel()
    cam = bridge.camera_from_numpy(
        {f: np.asarray(getattr(JCamera.look_at(), f)) for f in bridge.CAMERA_FIELDS})
    target, _ = render(s, cam, 8, 8, 2, 2, seed=1)
    refreshed = []
    monkeypatch.setattr(sharded, "refresh_accel",
                        lambda *a: refreshed.append(1) or refresh_accel(*a))
    fitted, losses = fit_scene(s, target * 0.9, cam, steps=3, spp=2, max_bounce=2,
                               trainable=["triangles.normal", "triangles.b"],
                               accel_rebuild_every=2)
    assert len(losses) == 3 and np.isfinite(losses).all() and len(refreshed) == 5
    assert not torch.equal(fitted.triangles.normal, s.triangles.normal)
    assert torch.equal(fitted.triangles.c, s.triangles.c)
    assert torch.equal(fitted.triangles.albedo, s.triangles.albedo)
    want = build_accel(fitted.triangles, n)
    for f in ("aabb_lo", "aabb_hi", "packed_plane", "orig_idx"):
        assert torch.equal(getattr(fitted.accel, f), getattr(want, f)), f


def test_train_step_searches_its_own_refreshed_accel(monkeypatch):
    """A scene passed back with the accel the step returned skips the
    refresh before the loss; the losses and trained leaves equal those of
    steps that refresh every time (a copy of the accel each call) bit for
    bit, and an in-place change to the params makes the step refresh
    again."""
    import dataclasses

    from raytracingc_tpu_torch.parallel import sharded
    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt, tessellate

    box = scene_from_triangles_txt("examples/box_scene.txt")
    tris, n = tessellate(box.triangles, box.n_triangles, levels=3)
    s = dataclasses.replace(box, triangles=tris, n_triangles=n, accel=None).with_accel()
    cam = bridge.camera_from_numpy(
        {f: np.asarray(getattr(JCamera.look_at(), f)) for f in bridge.CAMERA_FIELDS})
    target, _ = render(s, cam, 8, 8, 2, 2, seed=1)
    origins, dirs = primary_rays(cam, 8, 8)
    refreshed = []
    monkeypatch.setattr(sharded, "refresh_accel",
                        lambda *a: refreshed.append(1) or refresh_accel(*a))
    runs = []
    for carry in (True, False):
        params = {k: t.detach().clone().requires_grad_(k == ".triangles.normal")
                  for k, t in scene_leaves(s).items()}
        opt = torch.optim.Adam([params[".triangles.normal"]], lr=1e-2)
        step = sharded.make_train_step(None, opt, spp=2, max_bounce=2, seed=3)
        current, losses, start = s, [], len(refreshed)
        for _ in range(3):
            if not carry:
                current = dataclasses.replace(
                    current, accel=dataclasses.replace(current.accel))
            current, loss = step(current, params, origins, dirs,
                                 torch.arange(64), (target * 0.9).reshape(-1, 3))
            losses.append(loss)
        runs.append((losses, params[".triangles.normal"].detach().clone(),
                     len(refreshed) - start))
        if carry:
            with torch.no_grad():
                params[".triangles.normal"].mul_(1.0)
            step(current, params, origins, dirs, torch.arange(64),
                 (target * 0.9).reshape(-1, 3))
            assert len(refreshed) - start == 4 + 2
    assert runs[0][2] == 4 and runs[1][2] == 6
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_fit_camera_loss_decreases(demo):
    """examples/inverse_camera.py's perturbation (origin moved by ~0.18),
    fitted for a few steps at 24 x 24: the loss falls and the origin moves
    back toward the truth."""
    _, ts, _, tc = demo
    target, _ = render(ts, tc, 24, 24, 2, 2, seed=0)
    import dataclasses

    moved = dataclasses.replace(tc, origin=tc.origin + torch.tensor([0.12, -0.08, 0.1]))
    cam, losses = fit_camera(ts, target, moved, steps=25, learning_rate=1e-2, spp=2,
                             max_bounce=2)
    assert np.mean(losses[-5:]) < 0.5 * losses[0], losses
    assert (cam.origin - tc.origin).norm().item() < (moved.origin - tc.origin).norm().item()
    assert torch.allclose(cam.ez.norm(), torch.tensor(1.0))


def test_leaf_filter_and_geometry_rule_match_jax(demo):
    js, ts, _, _ = demo
    grads = {k: torch.ones_like(t) for k, t in scene_leaves(ts).items()}
    j_grads = jax.tree_util.tree_map(jnp.ones_like, js)
    for trainable in (["emission"], ["albedo"], ["triangles.albedo"], ["env"],
                      ["triangles.a", "spheres.center"]):
        got = leaf_filter(trainable)(grads)
        want = bridge.leaf_arrays(j_optimize.leaf_filter(trainable)(j_grads))
        for k in LEAF_PATHS:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for trainable in (None, ["albedo"], ["triangles.albedo"], ["triangles.a"],
                      ["normal"], ["env"], ["triangles"], ["a"]):
        assert is_geometry_trained(trainable) == j_optimize.is_geometry_trained(
            trainable), trainable


def test_unported_options_raise(demo):
    """Every option of fit_scene is ported; ``mesh=`` takes a mesh from
    ``parallel.make_mesh`` (its sharded steps: tests/test_torch_parallel.py)
    and raises on anything else."""
    _, ts, _, tc = demo
    target = torch.zeros((4, 4, 3))
    with pytest.raises(TypeError, match="DeviceMesh"):
        fit_scene(ts, target, tc, steps=1, mesh=object())


def test_fit_checkpoint_resume(demo, tmp_path):
    """tests/test_diff.py::test_fit_checkpoint_resume: a resumed fit runs
    only the steps after the saved one."""
    import dataclasses
    import os

    _, ts, _, tc = demo
    target, _ = render(ts, tc, 8, 8, 2, 2, seed=5, early_exit=False)
    perturbed = dataclasses.replace(ts, env=dataclasses.replace(
        ts.env, ground=torch.tensor([0.1, 0.1, 0.1])))
    ck = str(tmp_path / "fit.npz")
    kw = dict(spp=2, max_bounce=2, seed=5, trainable=["ground"],
              checkpoint_path=ck, checkpoint_every=2)
    _, l1 = fit_scene(perturbed, target, tc, steps=4, **kw)
    assert os.path.exists(ck) and len(l1) == 4
    _, l2 = fit_scene(perturbed, target, tc, steps=6, **kw)
    assert len(l2) == 2  # steps 4..5 only


def _geometry_scene():
    """box_scene tessellated to 640 triangles (5 blocks) with its accel."""
    import dataclasses

    from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt, tessellate

    box = scene_from_triangles_txt("examples/box_scene.txt")
    tris, n = tessellate(box.triangles, box.n_triangles, levels=3)
    return dataclasses.replace(box, triangles=tris, n_triangles=n,
                               accel=None).with_accel()


@pytest.mark.parametrize("kind", ["albedo", "geometry"])
def test_fit_resume_is_bitwise(demo, tmp_path, kind):
    """3 steps, then resumed from the checkpoint to 5, against 5 steps in
    one run: the resumed losses, the fitted leaves and the fitted accel
    equal bit for bit (the checkpoint carries Adam's step, exp_avg and
    exp_avg_sq, and the geometry run's accel rebuilt at step 1)."""
    from raytracingc_tpu_torch.scene.types import scene_leaves

    _, ts, _, tc = demo
    if kind == "albedo":
        scene = ts
        target, _ = render(ts, tc, 8, 8, 2, 2, seed=1)
        leaves = scene_leaves(ts)
        leaves[".triangles.albedo"] = leaves[".triangles.albedo"] * 0.5
        start = with_leaves(ts, leaves)
        kw = dict(trainable=["albedo"], learning_rate=5e-2)
    else:
        scene = _geometry_scene()
        target, _ = render(scene, tc, 8, 8, 2, 2, seed=1)
        target = target * 0.9
        start = scene
        kw = dict(trainable=["triangles.normal", "triangles.b", "triangles.c"],
                  learning_rate=1e-3, accel_rebuild_every=2)
    kw.update(spp=2, max_bounce=2, seed=1)
    whole, l_whole = fit_scene(start, target, tc, steps=5, **kw)
    ck = str(tmp_path / "fit.npz")
    _, l_first = fit_scene(start, target, tc, steps=3, checkpoint_path=ck, **kw)
    resumed, l_rest = fit_scene(start, target, tc, steps=5, checkpoint_path=ck, **kw)
    assert l_first + l_rest == l_whole and len(l_rest) == 2
    for k, v in scene_leaves(whole).items():
        assert torch.equal(scene_leaves(resumed)[k], v), k
    if kind == "geometry":
        assert not torch.equal(whole.triangles.normal, scene.triangles.normal)
        for f in ("aabb_lo", "aabb_hi", "packed_plane", "orig_idx"):
            assert torch.equal(getattr(resumed.accel, f), getattr(whole.accel, f)), f


def test_pixel_grad_fd_pass_rate(untied, demo):
    """tests/test_diff.py::test_pixel_grad_fd_pass_rate's bar, >= 0.9."""
    res = pixel_grad_check(untied[1], demo[3], width=8, height=8, spp=2,
                           max_bounce=2, eps=1e-3, rtol=2e-2, atol=5e-6,
                           probes_per_leaf=4)
    assert res["pass_rate"] >= 0.9, {k: v for k, v in res.items() if k != "pass_rate"}


def test_env_grad_exact(demo):
    """tests/test_diff.py::test_env_grad_exact: environment colours are
    smooth, so every probe passes."""
    res = pixel_grad_check(demo[1], demo[3], width=8, height=8, spp=1, max_bounce=1,
                           leaves=["sky_horizon", "sky_zenith", "ground"],
                           eps=1e-3, rtol=1e-2, probes_per_leaf=6)
    assert res["pass_rate"] == 1.0, res
    assert set(res) == {".env.sky_horizon", ".env.sky_zenith", ".env.ground",
                        "pass_rate"}


def test_fd_check_on_named_params():
    """fd_check on a plain dict of named tensors: a smooth loss passes every
    probe, a wrong gradient fails them."""
    params = {"x": torch.tensor([0.3, -1.2, 2.0]), "y": torch.tensor(0.7)}
    good = lambda p: (p["x"] ** 3).sum() * p["y"]
    assert fd_check(good, params, probes_per_leaf=3)["pass_rate"] == 1.0

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return 2.0 * g

    bad = lambda p: (Wrong.apply(p["x"]) ** 2).sum()
    assert fd_check(bad, params, leaves=["x"], probes_per_leaf=3)["pass_rate"] == 0.0


def test_bridge_carries_leaves_and_pose(demo):
    js, ts, jc, _ = demo
    arrays = bridge.leaf_arrays(js)
    for k, t in scene_leaves(ts).items():
        np.testing.assert_array_equal(arrays[k], t.numpy(), err_msg=k)
    pose = bridge.pose_arrays(jc)
    np.testing.assert_array_equal(pose["dir"], np.asarray(jc.ez))
    assert set(bridge.pose_arrays({"origin": jc.origin, "dir": jc.ez})) == {
        "origin", "dir"}
    with pytest.raises(KeyError):
        with_leaves(ts, {".triangles.nope": ts.triangles.a})
