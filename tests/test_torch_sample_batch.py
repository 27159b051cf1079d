"""Port parity: the widened ``sample_batch`` path of ``trace_accumulate``.

The JAX package traces ``sample_batch`` samples of every ray as one batch of
``sample_batch * R`` lanes, the primary hit tiled to that width
(``raytracingc_tpu/render/integrator.py``'s ``sample_batch > 1`` branch);
the port's ``_batch_accumulate`` is held to it on the same numpy inputs
(box_scene + sphere and the demo scene, 16x16): traced-ray counts equal
exactly (JAX sums them in float32, exact below 2**24; the largest count
here is under 2**13), radiance at the render tolerances of
tests/test_torch_render.py (pixels within 1e-4 on >= 99.5%, mean |diff| <=
1e-3), gradients of the differentiable modes at
``test_torch_diff.GRAD_RTOL``. Within the port: every mode of one width
gives the same bits, and each is within float re-association (``REASSOC``)
of production with the same count; ``sample_offset`` shifts the sample ids
as in JAX, and chunking changes no bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingc_tpu.camera import primary_rays as j_primary_rays
from raytracingc_tpu.render.integrator import trace_accumulate as j_trace
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.camera import primary_rays
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.types import LEAF_PATHS, scene_leaves, with_leaves
from test_torch_diff import GRAD_RTOL, demo  # noqa: F401  (fixture)
from test_torch_integrator_modes import REASSOC, scenes  # noqa: F401  (fixture)
from test_torch_render import _assert_images_close

MODES = [(True, True), (True, False), (False, True), (False, False)]
# (spp, sample_batch, max_bounce): each spp with each width once, each
# max_bounce twice ("auto" is 4 at spp 4 and 8 at spp 8).
CASES = [(4, 2, 1), (4, 4, 2), (4, "auto", 3), (8, 2, 3), (8, 4, 1), (8, "auto", 2)]
SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(scenes, demo):  # noqa: F811
    return {"box": scenes, "demo": demo}


@pytest.mark.parametrize("scene", ["box", "demo"])
@pytest.mark.parametrize("early_exit,compact", MODES)
@pytest.mark.parametrize("spp,sample_batch,max_bounce", CASES)
def test_sample_batch_matches_jax(both, scene, early_exit, compact, spp,
                                  sample_batch, max_bounce):
    js, ts, jc, tc = both[scene]
    o, d = j_primary_rays(jc, SIZE, SIZE)
    ids = jnp.arange(SIZE * SIZE, dtype=jnp.uint32)
    kw = dict(seed=7, spp=spp, max_bounce=max_bounce, early_exit=early_exit,
              compact=compact, sample_batch=sample_batch)
    jr, jn = j_trace(o, d, js, ids, **kw)
    to, td = primary_rays(tc, SIZE, SIZE)
    tr, tn = trace_accumulate(to, td, ts, torch.arange(SIZE * SIZE), **kw)
    assert isinstance(tn, int) and tn == int(jn) and tn < 2**24
    _assert_images_close(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("max_bounce", [1, 2])
@pytest.mark.parametrize("sample_batch", [2, "auto"])
@pytest.mark.parametrize("compact", [True, False])
def test_sample_batch_gradients_match_jax(demo, compact, sample_batch,  # noqa: F811
                                          max_bounce):
    """``jax.grad`` against autograd of the differentiable modes
    (``early_exit=False``, either ``compact``: both run the masked scan),
    leaf by leaf, as tests/test_torch_diff.py::test_gradients_match_jax."""
    js, ts, jc, tc = demo
    w = h = 8
    wts = np.random.default_rng(0).standard_normal((w * h, 3)).astype(np.float32)
    kw = dict(seed=0, spp=4, max_bounce=max_bounce, early_exit=False,
              compact=compact, sample_batch=sample_batch)
    o, d = j_primary_rays(jc, w, h)
    ids = jnp.arange(w * h, dtype=jnp.uint32)

    def j_loss(s):
        return jnp.mean(j_trace(o, d, s, ids, **kw)[0] * jnp.asarray(wts))

    j_val, j_grad = jax.value_and_grad(j_loss)(js)
    want = bridge.leaf_arrays(j_grad)

    leaves = {k: t.clone().requires_grad_(True) for k, t in scene_leaves(ts).items()}
    to, td = primary_rays(tc, w, h)
    rad, _ = trace_accumulate(to, td, with_leaves(ts, leaves), torch.arange(w * h),
                              **kw)
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


def test_sample_batch_modes_in_the_port(scenes):  # noqa: F811
    """Every mode of one width gives the same bits (the early-exit loop and
    the masked scan trace each lane alike), "auto" is 8 at spp 8, and each
    is within re-association of production with production's count."""
    _, ts, _, tc = scenes
    args = (48, 40, 8, 5)
    prod, n = render(ts, tc, *args, seed=2)
    widths = {}
    for sb in (2, 4, 8, "auto"):
        imgs = []
        for early_exit, compact in MODES:
            img, cnt = render(ts, tc, *args, seed=2, sample_batch=sb,
                              early_exit=early_exit, compact=compact)
            assert isinstance(cnt, int) and cnt == n, (sb, early_exit, compact)
            np.testing.assert_allclose(img.numpy(), prod.numpy(), **REASSOC)
            imgs.append(img)
        for img in imgs[1:]:
            assert torch.equal(img.view(torch.int32), imgs[0].view(torch.int32)), sb
        widths[sb] = imgs[0]
    assert torch.equal(widths["auto"].view(torch.int32), widths[8].view(torch.int32))
    assert not torch.equal(widths[2], prod)  # it does associate differently


def test_sample_offset_and_chunking(scenes):  # noqa: F811
    """``sample_offset`` under ``sample_batch`` against JAX's, and the
    port's image the same bits at any ``pixel_chunk`` (a ragged one too)."""
    js, ts, jc, tc = scenes
    args = (32, 24, 4, 3)
    kw = dict(seed=3, sample_offset=5, sample_batch=2)
    ji, jn = j_render(js, jc, *args, **kw)
    a, na = render(ts, tc, *args, **kw)
    assert na == int(jn)
    _assert_images_close(a.numpy(), np.asarray(ji))
    b, nb = render(ts, tc, *args, pixel_chunk=256, **kw)
    c, nc = render(ts, tc, *args, pixel_chunk=250, early_exit=False, **kw)
    assert na == nb == nc
    assert torch.equal(b.view(torch.int32), a.view(torch.int32))
    assert torch.equal(c.view(torch.int32), a.view(torch.int32))
    z, _ = render(ts, tc, *args, seed=3, sample_batch=2)
    assert not torch.equal(z, a)  # the offset moved the sample ids


def test_sample_batch_validation(scenes):  # noqa: F811
    """The JAX package's refusals, the same exception types: a width that
    does not divide spp (its assert), and sample_group with sample_batch."""
    js, ts, jc, tc = scenes
    for kw in (dict(spp=4, sample_batch=3), dict(spp=6, sample_batch=4)):
        with pytest.raises(AssertionError):
            j_render(js, jc, 8, 8, max_bounce=2, **kw)
        with pytest.raises(AssertionError):
            render(ts, tc, 8, 8, max_bounce=2, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        render(ts, tc, 8, 8, 4, 2, sample_batch=2, sample_group=2)
    # "auto" takes the largest of 8, 4, 2, 1 dividing spp: at spp 3, 1.
    one, n1 = render(ts, tc, 8, 8, 3, 2, sample_batch=1)
    auto, na = render(ts, tc, 8, 8, 3, 2, sample_batch="auto")
    assert n1 == na and torch.equal(one.view(torch.int32), auto.view(torch.int32))
