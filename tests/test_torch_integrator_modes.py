"""Port parity: the integrator's other modes.

``trace_accumulate``'s differentiable fast forward (``early_exit=False,
compact=True``), the plain full-width oracle (``compact=False``) and
``sample_group`` against the JAX package on ``box_scene`` + sphere, at the
render tolerances of tests/test_torch_render.py (traced-ray counts equal,
pixels within 1e-4 on >= 99.5%, mean |diff| <= 1e-3: XLA and torch round
log/cos and FMA contractions differently, so a ray near an edge may take
another path). Within the port: every hit-front mode equals production bit
for bit, under autograd too; the oracle agrees to float re-association
(rtol 3e-6, atol 3e-7, the JAX package's own bound in
tests/test_utils.py::test_early_exit_matches_scan) with equal counts; the
JAX package's validation errors; early exit under grad raises.
"""

import os

import numpy as np
import pytest
import torch

from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.camera import primary_rays
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves
from test_torch_render import _assert_images_close

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
REASSOC = dict(rtol=3e-6, atol=3e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity renders run torch on one thread."""
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


@pytest.mark.parametrize("mode", [
    dict(early_exit=False, compact=True),
    dict(early_exit=False, compact=False),
    dict(early_exit=False, sample_group=2),
    dict(early_exit=True, sample_group="auto"),
])
def test_modes_match_jax(scenes, mode):
    """8,192-pixel chunks: JAX's compacted hit-front branch (k0 >= 1024)."""
    js, ts, jc, tc = scenes
    args = (128, 64, 4, 3)
    ji, jn = j_render(js, jc, *args, seed=11, pixel_chunk=8192, **mode)
    ti, tn = render(ts, tc, *args, seed=11, pixel_chunk=8192, **mode)
    assert tn == int(jn)
    _assert_images_close(ti.numpy(), np.asarray(ji))


def test_modes_equal_production_in_the_port(scenes):
    _, ts, _, tc = scenes
    args = (48, 40, 4, 5)
    prod, n = render(ts, tc, *args, seed=2)
    for mode in (dict(early_exit=False), dict(early_exit=True, compact=False),
                 dict(early_exit=False, sample_group=2),
                 dict(early_exit=False, sample_group=4),
                 dict(early_exit=True, sample_group="auto")):
        img, cnt = render(ts, tc, *args, seed=2, **mode)
        assert cnt == n, mode
        assert torch.equal(img.view(torch.int32), prod.view(torch.int32)), mode
    img, cnt = render(ts, tc, *args, seed=2, early_exit=False, compact=False)
    assert cnt == n
    np.testing.assert_allclose(img.numpy(), prod.numpy(), **REASSOC)
    assert not torch.equal(img, prod)  # it does associate differently


def test_differentiable_forward_under_grad_is_production(scenes):
    """With every scene leaf requiring grad, the fast forward's values and
    count are production's bits, and backward reaches the leaves."""
    _, ts, _, tc = scenes
    o, d = primary_rays(tc, 24, 24)
    ids = torch.arange(24 * 24)
    kw = dict(seed=5, spp=3, max_bounce=4)
    with torch.no_grad():
        want, n = trace_accumulate(o, d, ts, ids, early_exit=True, **kw)
    leaves = {k: t.clone().requires_grad_(True) for k, t in scene_leaves(ts).items()}
    got, m = trace_accumulate(o, d, with_leaves(ts, leaves), ids, **kw)
    assert m == n and got.requires_grad
    assert torch.equal(got.detach().view(torch.int32), want.view(torch.int32))
    got.sum().backward()
    for name in (".triangles.albedo", ".triangles.emission", ".env.sky_zenith"):
        g = leaves[name].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0, name


def test_validation_errors_match_jax(scenes):
    """The JAX package's sample_group errors (render/integrator.py:291-311),
    with its messages; sample_batch=2 runs, and a sample_batch that does
    not divide spp is refused as JAX refuses it (an AssertionError)."""
    from raytracingc_tpu.render.integrator import trace_accumulate as j_trace

    js, ts, _, _ = scenes
    o = np.zeros((8, 3), np.float32)
    d = np.zeros((8, 3), np.float32)
    d[:, 2] = 1.0
    ids = np.arange(8, dtype=np.uint32)
    cases = [
        (dict(sample_group=3), "must divide spp"),
        (dict(early_exit=False, compact=False, sample_group=2),
         "requires the hit-front accumulator"),
        (dict(sample_group=2, sample_batch=2), "mutually exclusive"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            j_trace(o, d, js, ids, seed=0, spp=4, max_bounce=2, **kw)
        with pytest.raises(ValueError, match=msg):
            trace_accumulate(torch.from_numpy(o), torch.from_numpy(d), ts,
                             torch.from_numpy(ids.astype(np.int64)), seed=0,
                             spp=4, max_bounce=2, **kw)
    t = (torch.from_numpy(o), torch.from_numpy(d), ts, torch.arange(8))
    img, n = trace_accumulate(*t, seed=0, spp=4, max_bounce=2, sample_batch=2)
    assert img.shape == (8, 3) and n >= 32
    with pytest.raises(AssertionError):
        j_trace(o, d, js, ids, seed=0, spp=4, max_bounce=2, sample_batch=3)
    with pytest.raises(AssertionError):
        trace_accumulate(*t, seed=0, spp=4, max_bounce=2, sample_batch=3)
    with pytest.raises(ValueError, match="spp"):
        trace_accumulate(*t, seed=0, spp=0, max_bounce=2)


def test_early_exit_under_grad_raises(scenes):
    """The counterpart of tests/test_round2_fixes.py::
    test_early_exit_grad_raises_and_jvp_works: the production mode is
    forward-only and says which mode differentiates."""
    _, ts, _, tc = scenes
    o, d = primary_rays(tc, 4, 4)
    ids = torch.arange(16)
    leaves = scene_leaves(ts)
    leaves[".env.ground"] = leaves[".env.ground"].clone().requires_grad_(True)
    s = with_leaves(ts, leaves)
    with pytest.raises(ValueError, match="early_exit=False"):
        trace_accumulate(o, d, s, ids, seed=0, spp=1, max_bounce=2, early_exit=True)
    o_grad = o.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="early_exit=False"):
        trace_accumulate(o_grad, d, ts, ids, seed=0, spp=1, max_bounce=2,
                         early_exit=True)
    with torch.no_grad():  # forward-only use stays open
        img, n = trace_accumulate(o, d, s, ids, seed=0, spp=1, max_bounce=2,
                                  early_exit=True)
    assert n > 0 and torch.isfinite(img).all()
