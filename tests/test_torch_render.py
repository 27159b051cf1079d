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
from raytracingc_tpu.camera import primary_rays as j_primary_rays
from raytracingc_tpu.render.integrator import render_debug as j_render_debug
from raytracingc_tpu.render.integrator import trace_paths as j_trace_paths
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu.render.renderer import render_image as j_render_image
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch import rng as trng
from raytracingc_tpu_torch.render.integrator import (
    render_debug,
    trace_accumulate,
    trace_paths,
)
from raytracingc_tpu_torch.render.renderer import render, render_image

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
    """A lane's radiance does not depend on the chunk it is traced in: bit
    for bit, with equal counts. torch's CPU pow rounds differently in its
    vector loop and in the scalar loop over a tensor's tail, which moved a
    lane by up to 1.2e-7 between chunkings; ``ops/env_light.py`` pads it to
    whole vectors, and ``rng.next_normal`` pads its log and cos the same way
    (``rng.lanewise``; on torch 2.13's CPU build those two were measured
    position-independent already)."""
    _, ts, _, tc = scenes
    a, na = render(ts, tc, 128, 64, 2, 4, seed=3)  # default chunk: 8,192
    b, nb = render(ts, tc, 128, 64, 2, 4, seed=3, pixel_chunk=1024)
    c, nc = render(ts, tc, 128, 64, 2, 4, seed=3, pixel_chunk=1000)  # ragged
    assert na == nb == nc
    assert torch.equal(b.view(torch.int32), a.view(torch.int32))
    assert torch.equal(c.view(torch.int32), a.view(torch.int32))


def test_render_modes_and_arguments(scenes):
    _, ts, _, tc = scenes
    o = torch.zeros((8, 3))
    d = torch.zeros((8, 3))
    d[:, 2] = 1.0
    ids = torch.arange(8)
    # The other modes run (tests/test_torch_integrator_modes.py holds their
    # values, tests/test_torch_sample_batch.py sample_batch's); a
    # sample_batch that does not divide spp is refused, as JAX's assert does.
    for kw in (dict(early_exit=False), dict(compact=False),
               dict(early_exit=False, compact=False), dict(sample_group=2),
               dict(sample_batch=2)):
        img, n = trace_accumulate(o, d, ts, ids, seed=0, spp=2, max_bounce=2, **kw)
        assert img.shape == (8, 3) and n >= 16, kw
    with pytest.raises(AssertionError):
        trace_accumulate(o, d, ts, ids, seed=0, spp=2, max_bounce=2, sample_batch=4)
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


# --- The bounce-count heatmap, render_image and intersect -------------------


def test_render_debug_matches_jax(scenes):
    """The heatmap against the JAX package's: values are multiples of
    1/max_bounce; equal on >= 99.5% of pixels (a ray near an edge may take
    another path, as in the radiance renders)."""
    js, ts, jc, tc = scenes
    want = np.asarray(j_render_debug(js, jc, 24, 16, max_bounce=4, seed=3))
    got = render_debug(ts, tc, 24, 16, max_bounce=4, seed=3).numpy()
    assert got.shape == want.shape == (16, 24, 3)
    assert np.array_equal(got * 4, np.round(got * 4))
    same = (got == want).all(-1)
    assert same.mean() >= MIN_CLOSE_FRAC, (same.mean(), np.argwhere(~same)[:10])
    assert 0.0 < got.mean() < 1.0


def _mirror_corridor():
    """tests/test_round2_fixes.py's scene: two huge dark mirrors facing each
    other, so that every path ping-pongs until max_bounce (albedo 0.05: a
    roulette would end almost every path after its first hit)."""
    from raytracingc_tpu_torch.scene.builder import triangles_from_arrays
    from raytracingc_tpu_torch.scene.types import EnvParams, Scene, Spheres

    s = 1000.0
    verts = np.array([[[-s, -s, 3], [0, s, 3], [s, -s, 3]],
                      [[-s, -s, -3], [s, -s, -3], [0, s, -3]]], np.float32)
    normals = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    tris, n = triangles_from_arrays(verts, normals, np.full((2, 3), 0.05, np.float32),
                                    np.zeros(2, np.float32), np.ones(2, np.float32))
    return Scene(triangles=tris, spheres=Spheres.zeros(8), env=EnvParams.default(),
                 n_triangles=n, n_spheres=0).with_accel()


def test_debug_heatmap_has_no_roulette():
    from raytracingc_tpu_torch.camera import Camera

    cam = Camera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    img = render_debug(_mirror_corridor(), cam, 16, 16, max_bounce=6, seed=0)
    assert torch.equal(img, torch.ones_like(img))


def test_render_image_matches_jax(scenes, tmp_path):
    """Tonemapped bytes against the JAX package's render_image (bytes within
    1 on >= 99.5% of pixels: the radiance rule above, truncated to bytes),
    the file written equal to the returned bytes, and equal to tonemapping
    the port's own render."""
    from raytracingc_tpu_torch.render.image import read_image, tonemap_to_bytes

    js, ts, jc, tc = scenes
    want = j_render_image(js, jc, 16, 16, spp=4, max_bounce=3, seed=2)
    out = str(tmp_path / "port.png")
    got = render_image(ts, tc, 16, 16, spp=4, max_bounce=3, seed=2, output=out)
    assert got.dtype == np.uint8 and got.shape == want.shape == (16, 16, 3)
    near = (np.abs(got.astype(int) - want.astype(int)) <= 1).all(-1)
    assert near.mean() >= MIN_CLOSE_FRAC, near.mean()
    np.testing.assert_array_equal(read_image(out), got)
    linear, _ = render(ts, tc, 16, 16, spp=4, max_bounce=3, seed=2)
    np.testing.assert_array_equal(tonemap_to_bytes(linear.numpy()), got)


def _sphere_only_pair():
    from raytracingc_tpu.scene.types import Scene as JScene
    from raytracingc_tpu.scene.types import Spheres as JSpheres

    # No live triangle: 128 all-zero padding rows (the port's Scene needs a
    # row; the JAX builders pad the same way).
    jtris, n = jb.triangles_from_arrays(
        np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32),
        np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
        np.zeros(0, np.float32))
    jsph = JSpheres(center=jnp.array([[0.0, 0.0, 6.0], [1.5, 0.5, 9.0]]),
                    radius=jnp.array([1.5, 2.0]),
                    albedo=jnp.array([[0.2, 0.4, 0.6], [0.9, 0.1, 0.1]]),
                    emission=jnp.array([0.0, 3.0]),
                    smoothness=jnp.array([0.25, 0.0]))
    js = JScene.build(triangles=jtris, spheres=jsph).replace(n_triangles=n)
    ts = bridge.scene_from_numpy(
        {f: np.asarray(getattr(js.triangles, f)) for f in bridge.TRIANGLE_FIELDS},
        {f: np.asarray(getattr(js.spheres, f)) for f in bridge.SPHERE_FIELDS},
        {f: np.asarray(getattr(js.env, f)) for f in bridge.ENV_FIELDS},
        js.n_triangles, js.n_spheres)
    return js, ts


@pytest.mark.parametrize("which", ["spheres_only", "box_scene"])
def test_intersect_matches_jax(scenes, which):
    """intersect (search + resolve) against the JAX package's
    ``intersect(backend="xla")``: hit flags equal, geometry and materials to
    rtol 1e-5, atol 1e-5 (tests/test_torch_search.py's resolve bound)."""
    from raytracingc_tpu.ops.intersect import intersect as j_intersect
    from raytracingc_tpu_torch.ops.intersect import intersect

    if which == "spheres_only":
        js, ts = _sphere_only_pair()
        jc = JCamera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    else:
        js, ts, jc, _ = scenes
    o, d = (np.array(x) for x in j_primary_rays(jc, 16, 16))
    jhit = j_intersect(jnp.asarray(o), jnp.asarray(d), js, backend="xla")
    thit = intersect(torch.from_numpy(o), torch.from_numpy(d), ts)
    np.testing.assert_array_equal(thit.hit.numpy(), np.asarray(jhit.hit))
    assert 10 < int(thit.hit.sum()) < o.shape[0] or which == "box_scene"
    for f in ("dst", "point", "normal", "albedo", "emission", "smoothness"):
        np.testing.assert_allclose(getattr(thit, f).numpy(), np.asarray(getattr(jhit, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
