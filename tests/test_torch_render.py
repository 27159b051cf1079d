"""Port parity: the bounce loop and the production forward render.

JAX ``trace_paths`` / ``render`` (early exit, compaction: the production
mode) against the port on ``box_scene`` + sphere at the same seed. Traced-ray
counts must be equal. Images agree to rtol 1e-4, atol 1e-4 on >= 99.5% of
pixels with mean |diff| <= 1e-3: XLA and torch evaluate log/cos (Box–Muller)
and FMA contraction differently by ulps, so a ray near an edge may take
another path.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingc_tpu import rng as jrng
from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.render.integrator import trace_paths as j_trace_paths
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch import rng as trng
from raytracingc_tpu_torch.render.integrator import trace_accumulate, trace_paths
from raytracingc_tpu_torch.render.renderer import render

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
PIXEL_TOL = 1e-4
MIN_CLOSE_FRAC = 0.995
MAX_MEAN_ABS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's multi-threaded CPU log/cos were seen to return values up to
    1.9e-5 off on a few percent of lanes in the first such call of a process
    (about one run in five; later calls were right). Parity runs on one
    thread, where it was not seen."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
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


def _assert_images_close(got, want):
    close = np.isclose(got, want, rtol=PIXEL_TOL, atol=PIXEL_TOL).all(-1)
    mean_abs = float(np.abs(got - want).mean())
    assert close.mean() >= MIN_CLOSE_FRAC, (close.mean(), np.argwhere(~close)[:10])
    assert mean_abs <= MAX_MEAN_ABS, mean_abs
    return close.mean(), mean_abs


def test_trace_paths_matches_jax(scenes):
    """One sample of the bounce loop from random rays inside the box."""
    js, ts, _, _ = scenes
    rs = np.random.default_rng(2)
    r = 4096
    o = rs.uniform(-5, 1.5, size=(r, 3)).astype(np.float32)
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rs.uniform(size=r) > 0.2
    ids = np.arange(r, dtype=np.uint32)
    state = np.asarray(jrng.stream_init(3, jnp.asarray(ids), 5))
    jl, jn = j_trace_paths(jnp.asarray(o), jnp.asarray(d), jnp.asarray(state), js,
                           max_bounce=6, active=jnp.asarray(active),
                           early_exit=True, compact=True)
    jl, jn = np.asarray(jl), int(jn)

    tl, tn = trace_paths(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(state.astype(np.int64)), ts,
                         max_bounce=6, active=torch.from_numpy(active))
    assert tn == jn
    _assert_images_close(tl.numpy(), jl)
    assert (tl.numpy()[~active] == 0).all()


@pytest.mark.parametrize(
    "width,height,spp,bounces,chunk",
    [
        (16, 16, 4, 3, None),
        # >= 8,192-pixel chunks run JAX's compacted hit-front branch (k0 >= 1024).
        (128, 64, 2, 3, 8192),
    ],
)
def test_render_matches_jax(scenes, width, height, spp, bounces, chunk):
    js, ts, jc, tc = scenes
    ji, jn = j_render(js, jc, width, height, spp, bounces, seed=7, pixel_chunk=chunk)
    ji, jn = np.asarray(ji), int(jn)

    ti, tn = render(ts, tc, width, height, spp, bounces, seed=7, pixel_chunk=chunk)
    assert isinstance(tn, int)
    assert tn == jn
    assert ti.shape == (height, width, 3) and ti.dtype == torch.float32
    assert np.isfinite(ti.numpy()).all()
    _assert_images_close(ti.numpy(), ji)


def test_render_chunking_invariance(scenes):
    """A lane's radiance does not depend on the chunk it is traced in, up to
    rtol 1e-6: torch's CPU kernels evaluate log/cos vectorised on full
    vectors and by scalar libm on a tensor's tail, so a lane's position in a
    chunk can move it by an ulp. Observed: not bitwise, max |diff| 1.2e-7
    (8,192 vs 1,024) and 7.5e-9 (8,192 vs 1,000); counts equal."""
    _, ts, _, tc = scenes
    a, na = render(ts, tc, 128, 64, 2, 4, seed=3)  # default chunk: 8,192
    b, nb = render(ts, tc, 128, 64, 2, 4, seed=3, pixel_chunk=1024)
    c, nc = render(ts, tc, 128, 64, 2, 4, seed=3, pixel_chunk=1000)  # ragged
    assert na == nb == nc
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-6, atol=0)


def test_render_modes_and_arguments(scenes):
    _, ts, _, tc = scenes
    o = torch.zeros((8, 3))
    d = torch.zeros((8, 3))
    d[:, 2] = 1.0
    ids = torch.arange(8)
    # The other modes run (tests/test_torch_integrator_modes.py holds their
    # values); sample_batch stays out of the port (ROADMAP item 11).
    for kw in (dict(early_exit=False), dict(compact=False),
               dict(early_exit=False, compact=False), dict(sample_group=2)):
        img, n = trace_accumulate(o, d, ts, ids, seed=0, spp=2, max_bounce=2, **kw)
        assert img.shape == (8, 3) and n >= 16, kw
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        trace_accumulate(o, d, ts, ids, seed=0, spp=2, max_bounce=2, sample_batch=2)
    with pytest.raises(ValueError):
        trace_accumulate(o, d, ts, ids, seed=0, spp=0, max_bounce=2)
    img, n = render(ts, tc, 8, 8, 2, 0)
    assert n == 0 and not img.any()
    # One bounce: primary hits only, one traced ray per pixel per sample.
    img, n = render(ts, tc, 8, 8, 3, 1)
    assert n == 8 * 8 * 3 and img.shape == (8, 8, 3)
    # The RNG state layout the integrator uses: int64 in [0, 2**32).
    s = trng.stream_init(0, ids, 2**32 - 1)
    assert s.dtype == torch.int64 and int(s.min()) >= 0 and int(s.max()) < 2**32
