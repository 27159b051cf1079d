"""Two checks of the port's training path against the JAX package on the
same inputs (ROADMAP Queue 3, C2 and C3).

C2, the FD criterion. JAX's ``pixel_grad_check`` and the port's FD check
on the same untied demo scene, camera, probes (numpy's generator in the
same leaf order), steps and projection weights (JAX's
``jax.random.normal`` draw, carried as numpy: the port's
``pixel_grad_check`` draws its own from a ``torch.Generator``, which gives
another loss), at ``tests/test_diff.py``'s settings and at the card run's
(16x16, a step of 1e-2, 8 probes a leaf): the port's pass rate is at least
JAX's, overall and leaf by leaf, and on ``.spheres.smoothness`` (the leaf of
every miss on the card) the same probes pass.

C3, the rising losses of the card's run (q). JAX's ``fit_scene`` (the face
normals and vertices b, c against a 0.9-dimmed target) and ``fit_camera``
(the origin moved by (0.12, -0.08, 0.1)) and the port's, on box_scene
--tessellate 2 at 16x16, spp 2, 4 bounces, lr 1e-3, 5 steps: the loss
sequences agree within 1e-5 relative per step (observed: 2e-7). Both rise
in both packages (the reference's own behaviour, recorded in ROADMAP).

C3, the camera example's fit (``examples/inverse_camera.py`` and the port's,
through ``tests/camera_fit_witness.py``). At each camera of JAX's fit up to
its step 8, the port's loss is within 1e-5 relative of JAX's and its image
within 1e-4 of JAX's on every pixel: the per-step function is JAX's. Each
package on its own trajectory: the first 8 losses within 1e-4 relative and
the cameras after 8 steps within 1e-4 (the cameras drift apart by float32
rounding of the gradients; at step 8 the drift flips one primary ray from
the sphere to a triangle and the fits part, which the witness script
prints).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.diff.fd_check import pixel_grad_check as j_pixel_grad_check
from raytracingc_tpu.diff.optimize import fit_camera as j_fit_camera
from raytracingc_tpu.diff.optimize import fit_scene as j_fit_scene
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch.camera import primary_rays
from raytracingc_tpu_torch.diff import fd_check, fit_camera, fit_scene
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.render.renderer import render
import camera_fit_witness as witness
from test_torch_diff import demo, port_scene, untied  # noqa: F401  (fixtures)

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
FD_RUNS = {
    "test_diff": dict(width=8, height=8, spp=2, max_bounce=2, eps=1e-3, rtol=2e-2,
                      atol=5e-6, probes_per_leaf=4),
    "card": dict(width=16, height=16, spp=2, max_bounce=2, eps=1e-2, rtol=2e-2,
                 atol=5e-6, probes_per_leaf=8),
}
FD_LEAVES = ["albedo", "emission", "smoothness", "env"]  # pixel_grad_check's
FIT = dict(spp=2, max_bounce=4)
FIT_LEVEL, FIT_SIZE, FIT_STEPS, FIT_LR = 2, 16, 5, 1e-3
FIT_GEOMETRY = ["triangles.normal", "triangles.b", "triangles.c"]
LOSS_RTOL = 1e-5
# The camera example: its first 8 steps, and 9 of JAX's cameras (through
# step 8, where a primary ray flips and the two free fits part).
CAMERA_STEPS = 8
PIXEL_ATOL = 1e-4  # the forced images, per pixel (observed: 5.6e-5)
FREE_RTOL = 1e-4  # the free fits' losses and cameras (observed: 1.6e-5, 4.4e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("run", list(FD_RUNS))
def test_fd_pass_rate_at_least_jax(untied, demo, run):  # noqa: F811
    js, ts = untied
    jc, tc = demo[2], demo[3]
    kw = FD_RUNS[run]
    w, h, spp, b = kw["width"], kw["height"], kw["spp"], kw["max_bounce"]
    want = j_pixel_grad_check(js, jc, **kw)
    wts = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0),
                                                      (w * h, 3))))
    o, d = primary_rays(tc, w, h)

    def loss_fn(s):
        radiance, _ = trace_accumulate(o, d, s, torch.arange(w * h), seed=0,
                                       spp=spp, max_bounce=b)
        return (radiance * wts).mean()

    got = fd_check(loss_fn, ts, leaves=FD_LEAVES,
                   **{k: kw[k] for k in ("eps", "rtol", "atol", "probes_per_leaf")})
    assert got["pass_rate"] >= want["pass_rate"], (got["pass_rate"], want["pass_rate"])
    assert set(got) == set(want)
    for k in got:
        if k != "pass_rate":
            assert got[k]["pass"] >= want[k]["pass"], k
    flags = lambda res: [ok for _, _, ok in res[".spheres.smoothness"]["probes"]]
    assert flags(got) == flags(want)


@pytest.fixture(scope="module")
def fit_inputs():
    """box_scene --tessellate FIT_LEVEL with its accel, its production
    render as the target, and the default camera, in both packages."""
    from raytracingc_tpu_torch import bridge

    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    tris, n = jb.tessellate(js.triangles, js.n_triangles, levels=FIT_LEVEL)
    js = js.replace(triangles=tris, n_triangles=n, accel=None).with_accel()
    ts = port_scene(js).with_accel()
    jc = JCamera.look_at()
    tc = bridge.camera_from_numpy({f: np.asarray(getattr(jc, f))
                                   for f in bridge.CAMERA_FIELDS})
    j_target, _ = j_render(js, jc, FIT_SIZE, FIT_SIZE, **FIT, seed=0)
    t_target, _ = render(ts, tc, FIT_SIZE, FIT_SIZE, **FIT, seed=0)
    return js, ts, jc, tc, j_target, t_target


@pytest.mark.parametrize("fit", ["geometry", "camera"])
def test_fit_losses_match_jax(fit_inputs, fit):
    js, ts, jc, tc, j_target, t_target = fit_inputs
    if fit == "geometry":
        _, want = j_fit_scene(js, j_target * 0.9, jc, steps=FIT_STEPS,
                              learning_rate=FIT_LR, trainable=FIT_GEOMETRY, **FIT)
        _, got = fit_scene(ts, t_target * 0.9, tc, steps=FIT_STEPS,
                           learning_rate=FIT_LR, trainable=FIT_GEOMETRY, **FIT)
    else:
        shift = [0.12, -0.08, 0.1]
        _, want = j_fit_camera(js, j_target, jc.replace(origin=jc.origin
                                                        + jnp.asarray(shift)),
                               steps=FIT_STEPS, learning_rate=FIT_LR, **FIT)
        _, got = fit_camera(ts, t_target, dataclasses.replace(
            tc, origin=tc.origin + torch.tensor(shift)), steps=FIT_STEPS,
            learning_rate=FIT_LR, **FIT)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert len(got) == FIT_STEPS


@pytest.fixture(scope="module")
def camera_example():
    return witness.inputs()


def test_camera_example_matches_jax_at_its_cameras(camera_example):
    """At each of JAX's cameras of the example's fit through step 8, the
    port's loss is JAX's within LOSS_RTOL (observed: 2.2e-6) and its image
    within PIXEL_ATOL on every pixel."""
    rows = witness.forced(CAMERA_STEPS + 1, camera_example)
    np.testing.assert_allclose([r["port"] for r in rows], [r["jax"] for r in rows],
                               rtol=LOSS_RTOL, atol=0)
    assert max(r["max_pixel"] for r in rows) < PIXEL_ATOL, rows


def test_camera_example_fit_tracks_jax(camera_example):
    """Each package's own fit of the example: the first CAMERA_STEPS losses
    within FREE_RTOL relative of JAX's, and the two cameras after them
    within FREE_RTOL of each other."""
    jl, tl, jc, tc = witness.free(CAMERA_STEPS, camera_example)
    assert len(tl) == len(jl) == CAMERA_STEPS
    np.testing.assert_allclose(tl, jl, rtol=FREE_RTOL, atol=0)
    for f in ("origin", "ez"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   rtol=0, atol=FREE_RTOL, err_msg=f)
