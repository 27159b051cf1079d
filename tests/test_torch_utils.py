"""Port parity: checkpoints, progressive rendering, traces, supervision.

The progressive renderer is held against the JAX package's on
``__graft_entry__._demo_scene`` at 8x8 (test_torch_render.py's rule: rtol
and atol 1e-4 on >= 99.5% of pixels, mean |diff| <= 1e-3, traced rays
equal) and against the port's own one-shot render (re-association of the
sample average: rtol 2e-6, atol 2e-7, the JAX package's bound in
tests/test_utils.py; rays equal). A resumed render equals the uninterrupted
one bit for bit. Progressive checkpoints cross between the packages bit for
bit.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.render.progressive import render_progressive as j_progressive
from raytracingc_tpu.utils.checkpoint import load_pytree as j_load_pytree
from raytracingc_tpu.utils.checkpoint import save_pytree as j_save_pytree
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.render.progressive import render_progressive
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
from raytracingc_tpu_torch.utils import (
    RenderFailure,
    load_pytree,
    render_resilient,
    save_pytree,
    start_trace,
    stop_trace,
    trace_annotation,
)
from raytracingc_tpu_torch.utils.checkpoint import tree_leaves

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
RUN = dict(width=8, height=8, spp=4, max_bounce=2, seed=9)
REASSOC = dict(rtol=2e-6, atol=2e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity renders run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demo():
    """The JAX demo scene and default camera, in both packages."""
    from __graft_entry__ import _demo_scene

    js = _demo_scene()
    ts = bridge.scene_from_numpy(
        {f: np.asarray(getattr(js.triangles, f)) for f in bridge.TRIANGLE_FIELDS},
        {f: np.asarray(getattr(js.spheres, f)) for f in bridge.SPHERE_FIELDS},
        {f: np.asarray(getattr(js.env, f)) for f in bridge.ENV_FIELDS},
        js.n_triangles, js.n_spheres,
    )
    jc = JCamera.look_at()
    tc = bridge.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in bridge.CAMERA_FIELDS})
    return js, ts, jc, tc


def _progressive(demo, **kw):
    _, ts, _, tc = demo
    return render_progressive(ts, tc, RUN["width"], RUN["height"], RUN["spp"],
                              RUN["max_bounce"], seed=RUN["seed"], **kw)


def test_checkpoint_roundtrip_scene_with_accel(tmp_path):
    scene = scene_from_triangles_txt(BOX_SCENE)
    assert scene.accel is not None and scene.accel.mxu_coeffs is not None
    path = str(tmp_path / "scene.npz")
    save_pytree(path, scene, step=42)
    # The template carries the structure and dtypes, not the values.
    template = scene_from_triangles_txt(BOX_SCENE)
    template = template.to("cpu")
    for t in tree_leaves(template):
        t.zero_()
    restored, step = load_pytree(path, template)
    assert step == 42
    assert restored.n_triangles == scene.n_triangles == 10
    assert restored.n_spheres == scene.n_spheres == 1
    want, got = tree_leaves(scene), tree_leaves(restored)
    assert len(got) == len(want) == 7 + 5 + 6 + 7 + 6  # + no resolve_perm
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w)
    assert restored.accel.orig_idx.dtype == torch.int32
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            [f"leaf_{i}" for i in range(len(want))] + ["__step__"])


def test_checkpoint_refuses_another_structure(tmp_path):
    path = str(tmp_path / "pair.npz")
    save_pytree(path, (torch.zeros(4, 3), torch.zeros(())))
    with pytest.raises(ValueError, match="2 leaves, the template has 1"):
        load_pytree(path, (torch.zeros(4, 3),))
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, (torch.zeros(5, 3), torch.zeros(())))
    _, step = load_pytree(path, (torch.ones(4, 3), None, torch.ones(())))
    assert step is None


def test_checkpoint_roundtrip_adam_state(tmp_path):
    """An Adam state_dict round-trips: a second optimizer given the loaded
    state and parameters steps to the same bits as the first."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(5, 3, generator=gen).requires_grad_(True),
              torch.randn(7, generator=gen).requires_grad_(True)]
    opt = torch.optim.Adam(params, lr=1e-2)

    def step(ps, o, k):
        loss = sum(((p * (k + 1.5)) ** 2).sum() for p in ps)
        o.zero_grad()
        loss.backward()
        o.step()

    for k in range(3):
        step(params, opt, k)
    path = str(tmp_path / "adam.npz")
    save_pytree(path, ([p.detach() for p in params], opt.state_dict()), step=2)

    params2 = [torch.zeros_like(p).requires_grad_(True) for p in params]
    opt2 = torch.optim.Adam(params2, lr=1e-2)
    step(params2, opt2, 0)  # gives opt2 its state structure
    (loaded, state), saved = load_pytree(
        path, ([p.detach() for p in params2], opt2.state_dict()))
    assert saved == 2
    assert state["state"][0]["step"].item() == 3.0
    with torch.no_grad():
        for p, x in zip(params2, loaded):
            p.copy_(x)
    opt2.load_state_dict(state)
    for k in opt.state_dict()["state"]:
        for name, v in opt.state_dict()["state"][k].items():
            assert torch.equal(opt2.state_dict()["state"][k][name], v), (k, name)
    step(params, opt, 3)
    step(params2, opt2, 3)
    for p, q in zip(params, params2):
        assert torch.equal(p, q)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_progressive_checkpoint_crosses_packages(demo, tmp_path, writer):
    """(acc, count) written by either package's progressive renderer loads in
    the other bit for bit."""
    js, _, jc, _ = demo
    path = str(tmp_path / f"{writer}.npz")
    shape = (RUN["height"], RUN["width"], 3)
    if writer == "jax":
        j_progressive(js, jc, RUN["width"], RUN["height"], RUN["spp"],
                      RUN["max_bounce"], seed=RUN["seed"], batch_spp=2,
                      checkpoint_path=path)
        (acc, count), step = load_pytree(
            path, (torch.zeros(shape), torch.zeros((), dtype=torch.int64)))
        acc, count = acc.numpy(), int(count)
    else:
        _progressive(demo, batch_spp=2, checkpoint_path=path)
        (acc, count), step = j_load_pytree(
            path, (jnp.zeros(shape, jnp.float32), jnp.zeros((), jnp.float32)))
        acc, count = np.asarray(acc), float(count)
    with np.load(path) as data:
        assert int(data["__step__"]) == step == RUN["spp"]
        assert data["leaf_0"].dtype == np.float32
        np.testing.assert_array_equal(acc.view(np.int32),
                                      data["leaf_0"].view(np.int32))
        assert count == data["leaf_1"] and count > 0


def test_progressive_matches_jax(demo):
    js, _, jc, _ = demo
    want, n_want = j_progressive(js, jc, RUN["width"], RUN["height"], RUN["spp"],
                                 RUN["max_bounce"], seed=RUN["seed"], batch_spp=2)
    got, n_got = _progressive(demo, batch_spp=2)
    want, got = np.asarray(want), got.numpy()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert float(np.abs(got - want).mean()) <= 1e-3
    assert n_got == float(n_want)


def test_progressive_matches_oneshot(demo):
    _, ts, _, tc = demo
    ref, n_ref = render(ts, tc, RUN["width"], RUN["height"], spp=RUN["spp"],
                        max_bounce=RUN["max_bounce"], seed=RUN["seed"])
    img, n = _progressive(demo, batch_spp=2)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), **REASSOC)
    assert n == n_ref and isinstance(n, int)


def test_progressive_resume_is_bitwise(demo, tmp_path):
    ref, n_ref = _progressive(demo, batch_spp=1)
    ck = str(tmp_path / "render.npz")
    done = []

    def stop_after_two(d, total, partial):
        done.append(d)
        assert partial.shape == (RUN["height"], RUN["width"], 3)
        if d >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _progressive(demo, batch_spp=1, checkpoint_path=ck, on_batch=stop_after_two)
    assert done == [1, 2]
    with np.load(ck) as data:
        assert int(data["__step__"]) == 2
    img, n = _progressive(demo, batch_spp=1, checkpoint_path=ck,
                          on_batch=lambda d, t, p: done.append(d))
    assert done == [1, 2, 3, 4]  # the resumed run ran batches 3 and 4 only
    assert torch.equal(img, ref) and n == n_ref
    # resume=False starts over and overwrites the checkpoint.
    img2, _ = _progressive(demo, batch_spp=1, checkpoint_path=ck, resume=False)
    assert torch.equal(img2, ref)


def test_progressive_final_partial_batch_ungrouped(demo):
    """spp 5 in batches of 4 under sample_group=2: the final batch of 1 runs
    ungrouped (a group of 2 cannot divide it) and the image is the
    ungrouped run's bit for bit."""
    _, ts, _, tc = demo
    args = (ts, tc, RUN["width"], RUN["height"], 5, RUN["max_bounce"])
    with pytest.raises(ValueError, match="must divide"):
        render(ts, tc, RUN["width"], RUN["height"], spp=1,
               max_bounce=RUN["max_bounce"], sample_group=2)
    grouped, n_g = render_progressive(*args, batch_spp=4, sample_group=2)
    plain, n_p = render_progressive(*args, batch_spp=4)
    assert torch.equal(grouped, plain) and n_g == n_p


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"shard_strategy": "diagonal"}])
def test_progressive_multi_device_raises(demo, kw):
    """Sharded progressive renders are ported (tests/test_torch_parallel.py);
    a mesh not from ``parallel.make_mesh`` or an unknown strategy raises
    before any batch."""
    exc, match = ((TypeError, "DeviceMesh") if "mesh" in kw
                  else (ValueError, "unknown strategy"))
    with pytest.raises(exc, match=match):
        _progressive(demo, **kw)


def test_render_resilient_retries_and_refuses():
    state = {"progress": 0, "fails": 2}
    failures = []

    def batches():
        state["progress"] += 1
        if state["fails"] > 0:
            state["fails"] -= 1
            # The card's out-of-memory error is a RuntimeError.
            raise torch.cuda.OutOfMemoryError("transient device loss")
        return ("done", state["progress"])

    out = render_resilient(batches, progress=lambda: state["progress"],
                           max_retries=2, backoff_s=0.0,
                           on_failure=lambda e, k: failures.append(k))
    assert out == ("done", 3) and failures == [1, 2]

    def always_fails():
        raise RuntimeError("boom")

    with pytest.raises(RenderFailure, match="after 2 attempts"):
        render_resilient(always_fails, progress=lambda: 0, max_retries=1,
                         backoff_s=0.0)

    def not_a_device_failure():
        raise KeyError("bug")

    with pytest.raises(KeyError):
        render_resilient(not_a_device_failure, progress=lambda: 0, backoff_s=0.0)


def test_start_stop_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    start_trace(log_dir)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            start_trace(log_dir)
        with trace_annotation("rtc_probe"):
            torch.ones(64).cumsum(0)
    finally:
        path = stop_trace()
    assert os.path.dirname(path) == log_dir
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rtc_probe" for e in events)
    with pytest.raises(RuntimeError, match="no trace is running"):
        stop_trace()
