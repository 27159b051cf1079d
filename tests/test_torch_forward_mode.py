"""Forward-mode derivatives through the production render.

The port's ``torch.func.jvp`` and ``torch.autograd.forward_ad`` through
``trace_accumulate(early_exit=True)`` against ``jax.jvp`` of the JAX
integrator on the same scene and tangents (every float leaf of the demo
scene given a seeded tangent), at the reverse-mode parity test's
tolerances (``test_torch_diff.GRAD_RTOL``, relative to the largest
|tangent|); forward against reverse (``grad . v`` of the differentiable
fast forward); reverse mode through the production mode still raises, as
JAX's ``while_loop`` does (``tests/test_round2_fixes.py``'s
``test_early_exit_grad_raises_and_jvp_works``).

The search wrappers hand ``data_ptr()`` to the CUDA library, which a
functorch-wrapped tensor does not have. ``ops/no_tangent.py`` runs each
wrapper on the plain tensors underneath: here every route of
``ops/search.py`` runs under both forward modes with the production
render's bits, and a function that reads ``data_ptr()`` (as the CUDA
branches do) runs under ``no_tangent`` where it raises without.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from raytracingc_tpu.camera import primary_rays as j_primary_rays
from raytracingc_tpu.render.integrator import trace_accumulate as j_trace
from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.ops.no_tangent import no_tangent
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.scene.builder import (
    scene_from_triangles_txt,
    tessellate,
    triangles_from_arrays,
)
from raytracingc_tpu_torch.scene.types import Scene, Spheres, scene_leaves, with_leaves
from test_torch_diff import GRAD_RTOL, demo  # noqa: F401  (fixture)
from test_torch_search_packet import KNOBS

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
TINY_STREAM = {"RTC_STREAM_MAX_T": "256", "RTC_STREAM_TILE": "256"}
# Every route of ops/search.py on box_scene --tessellate 3 (640 triangles).
ROUTES = {
    "brute K1": {"RTC_KERNEL": "brute"},
    "bitmask K2": {"RTC_KERNEL": "packet"},
    "packed K3 resident": {"RTC_KERNEL": "packet", "RTC_BITMASK_MAX_WORDS": "0"},
    "packed K3 streamed": {"RTC_KERNEL": "packet", **TINY_STREAM},
    "range K4": {"RTC_KERNEL": "packet", "RTC_CULL": "range"},
    "range K5": {"RTC_KERNEL": "packet", "RTC_CULL": "range", **TINY_STREAM},
    "words K6": {"RTC_KERNEL": "packet", "RTC_STREAM_CULL": "words",
                 "RTC_BITMASK_MAX_WORDS": "0"},
    "words K7": {"RTC_KERNEL": "packet", "RTC_STREAM_CULL": "words", **TINY_STREAM},
    "mxu K8": {"RTC_KERNEL": "mxu"},
}


@pytest.fixture(autouse=True)
def _one_torch_thread_clean_knobs(monkeypatch):
    """Parity runs torch on one thread (test_torch_render.py); no RTC_*
    knob leaks in."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _jvp(fn, leaves, tangents, mode):
    """``(primal, tangent)`` of ``fn(leaves)`` by ``torch.func.jvp``
    (``mode="func"``) or ``torch.autograd.forward_ad``."""
    if mode == "func":
        return torch.func.jvp(fn, (leaves,), (tangents,))
    with fwAD.dual_level():
        out = fwAD.unpack_dual(fn({k: fwAD.make_dual(v, tangents[k])
                                   for k, v in leaves.items()}))
        return out.primal, out.tangent


def _two_tri_scene():
    """tests/test_round2_fixes.py's two-triangle scene, no sphere."""
    verts = np.array([[[-1, -1, 3], [0, 1, 3], [1, -1, 3]],
                      [[-1, -1, 6], [0, 1, 6], [1, -1, 6]]], np.float32)
    normals = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    tris, n = triangles_from_arrays(
        verts, normals, np.array([[0.8, 0.2, 0.2], [0.2, 0.8, 0.2]], np.float32),
        np.zeros(2, np.float32), np.zeros(2, np.float32))
    from raytracingc_tpu_torch.scene.types import EnvParams

    return Scene(triangles=tris, spheres=Spheres.zeros(1), env=EnvParams.default(),
                 n_triangles=n, n_spheres=0)


def test_early_exit_grad_raises_and_jvp_works():
    """Reverse mode through the production mode raises; torch.func.jvp and
    forward_ad through it give finite tangents."""
    scene = _two_tri_scene()
    cam = Camera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    o, d = primary_rays(cam, 4, 4)

    def loss(leaves):
        r, _ = trace_accumulate(o, d, with_leaves(scene, leaves), torch.arange(16),
                                seed=0, spp=1, max_bounce=2, early_exit=True)
        return r.sum()

    leaves = {k: t.clone().requires_grad_(True) for k, t in scene_leaves(scene).items()}
    with pytest.raises(ValueError, match="early_exit=False"):
        loss(leaves)
    plain = scene_leaves(scene)
    ones = {k: torch.ones_like(t) for k, t in plain.items()}
    for mode in ("func", "forward_ad"):
        value, dot = _jvp(loss, plain, ones, mode)
        assert torch.isfinite(value) and torch.isfinite(dot) and dot != 0, mode


@pytest.mark.parametrize("mode", ["func", "forward_ad"])
@pytest.mark.parametrize("max_bounce", [1, 2])
def test_jvp_matches_jax(demo, max_bounce, mode):  # noqa: F811
    """Tangent of the radiance image through the production mode on the
    demo scene, every float leaf given a seeded tangent, against jax.jvp;
    the primal is the production render's bits."""
    js, ts, jc, tc = demo
    w, h = 8, 8
    rng = np.random.default_rng(1)
    leaves = scene_leaves(ts)
    tangents = {k: rng.standard_normal(tuple(t.shape)).astype(np.float32)
                for k, t in leaves.items()}
    j_tan = jax.tree_util.tree_map(jnp.zeros_like, js)
    for name, v in tangents.items():
        _, group, field = name.split(".")
        j_tan = j_tan.replace(**{group: getattr(j_tan, group).replace(
            **{field: jnp.asarray(v)})})
    o, d = j_primary_rays(jc, w, h)
    ids = jnp.arange(w * h, dtype=jnp.uint32)
    _, want = jax.jvp(lambda s: j_trace(o, d, s, ids, seed=0, spp=2,
                                        max_bounce=max_bounce, early_exit=True)[0],
                      (js,), (j_tan,))
    want = np.asarray(want)

    to, td = primary_rays(tc, w, h)

    def f(lv):
        return trace_accumulate(to, td, with_leaves(ts, lv), torch.arange(w * h),
                                seed=0, spp=2, max_bounce=max_bounce,
                                early_exit=True)[0]

    primal, got = _jvp(f, leaves, {k: torch.from_numpy(v) for k, v in tangents.items()},
                       mode)
    assert torch.equal(_bits(primal), _bits(f(leaves)))
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_RTOL[max_bounce] * scale)


def test_forward_matches_reverse(demo):  # noqa: F811
    """jvp of a weighted loss through the production mode equals grad . v of
    the differentiable fast forward (the same radiance bit for bit) within
    1e-5 relative: the two sum their pixel and leaf terms in other orders."""
    _, ts, _, tc = demo
    w, h = 8, 8
    rng = np.random.default_rng(2)
    wts = torch.from_numpy(rng.standard_normal((w * h, 3)).astype(np.float32))
    leaves = scene_leaves(ts)
    v = {k: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
         for k, t in leaves.items()}
    o, d = primary_rays(tc, w, h)

    def loss(lv, early_exit):
        r, _ = trace_accumulate(o, d, with_leaves(ts, lv), torch.arange(w * h),
                                seed=0, spp=2, max_bounce=2, early_exit=early_exit)
        return (r * wts).sum()

    _, fwd = torch.func.jvp(lambda lv: loss(lv, True), (leaves,), (v,))
    grad_in = {k: t.clone().requires_grad_(True) for k, t in leaves.items()}
    loss(grad_in, False).backward()
    rev = sum(float((t.grad * v[k]).sum()) for k, t in grad_in.items()
              if t.grad is not None)
    assert abs(float(fwd) - rev) <= 1e-5 * abs(rev), (float(fwd), rev)


@pytest.fixture(scope="module")
def box640():
    box = scene_from_triangles_txt(BOX_SCENE)
    tris, n = tessellate(box.triangles, box.n_triangles, levels=3)
    return dataclasses.replace(box, triangles=tris, n_triangles=n,
                               accel=None).with_accel()


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_under_forward_mode(monkeypatch, box640, route):
    """Under RTC_* knobs that pick each route of ops/search.py, torch.func.jvp
    and forward_ad through the production render give its bits as the
    primal and the same tangent bit for bit."""
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    cam = Camera.look_at()
    o, d = primary_rays(cam, 8, 8)
    leaves = scene_leaves(box640)
    tangents = {k: torch.zeros_like(t) for k, t in leaves.items()}
    tangents[".triangles.albedo"] = torch.ones_like(leaves[".triangles.albedo"])
    tangents[".triangles.emission"] = torch.ones_like(leaves[".triangles.emission"])

    def f(lv):
        return trace_accumulate(o, d, with_leaves(box640, lv), torch.arange(64),
                                seed=0, spp=1, max_bounce=2, early_exit=True)[0]

    want = f(leaves)
    p1, t1 = _jvp(f, leaves, tangents, "func")
    p2, t2 = _jvp(f, leaves, tangents, "forward_ad")
    assert torch.equal(_bits(p1), _bits(want)) and torch.equal(_bits(p2), _bits(want))
    assert torch.equal(_bits(t1), _bits(t2))
    assert float(t1.abs().max()) > 0


def test_search_wrapper_on_functorch_tensors():
    """search_brute called on functorch-wrapped rays under torch.func.jvp:
    the winners' bits of the plain call, and no tangent on the distances."""
    rng = np.random.default_rng(3)
    tris, n = triangles_from_arrays(
        rng.uniform(-1, 1, (40, 3, 3)).astype(np.float32) + [0, 0, 4],
        np.tile(np.array([[0, 0, -1]], np.float32), (40, 1)),
        np.full((40, 3), 0.5, np.float32), np.zeros(40, np.float32),
        np.zeros(40, np.float32))
    tri = pack_triangles(tris, n)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(64, 3).contiguous()
    want_d, want_i = search_brute(o, d, tri, n)
    assert int((want_i >= 0).sum()) > 0

    wrapped = []

    def f(o_):
        wrapped.append(torch._C._functorch.is_functorch_wrapped_tensor(o_))
        return search_brute(o_, d, tri, n)

    dst, tangent, idx = torch.func.jvp(f, (o,), (torch.ones_like(o),), has_aux=True)
    assert wrapped == [True]
    assert torch.equal(_bits(dst), _bits(want_d)) and torch.equal(idx, want_i)
    assert torch.equal(tangent, torch.zeros_like(tangent))


@pytest.mark.parametrize("mode", ["func", "forward_ad", "reverse"])
def test_no_tangent_runs_on_plain_tensors(mode):
    """A function that reads data_ptr() (as every CUDA branch of the search
    wrappers does) runs under no_tangent in each autograd mode, with
    non-differentiable outputs; without it, torch.func.jvp raises."""
    def launch(x, scale=2.0):
        assert x.data_ptr() != 0
        return x * scale, (x > 0).to(torch.int32)

    wrapped = no_tangent(launch)
    x = torch.linspace(-1.0, 1.0, 8)

    def f(x_):
        y, _ = wrapped(x_, scale=3.0)
        return y + x_

    if mode == "func":
        y, dot = torch.func.jvp(f, (x,), (torch.ones_like(x),))
        with pytest.raises(RuntimeError, match="data pointer"):
            torch.func.jvp(lambda x_: launch(x_)[0], (x,), (torch.ones_like(x),))
    elif mode == "forward_ad":
        with fwAD.dual_level():
            out = fwAD.unpack_dual(f(fwAD.make_dual(x, torch.ones_like(x))))
        y, dot = out.primal, out.tangent
    else:
        xg = x.clone().requires_grad_(True)
        f(xg).sum().backward()
        y, dot = f(x), xg.grad
        assert not wrapped(xg)[0].requires_grad
    assert torch.equal(y, x * 3.0 + x)
    assert torch.equal(dot, torch.ones_like(x))  # only the identity term
