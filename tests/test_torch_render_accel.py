"""Port parity: renders through the accel path.

The port's loaders attach the same accel as the JAX loaders. On the CPU, the
port CLI renders ``box_scene --tessellate 4`` (2,560 triangles) through the
bitmask and the streamed packed routes with radiance and traced-ray counts
EQUAL to the brute route's (a dispatch choice never changes a result), and
close to the JAX CLI's (image mean within 0.01, the distribution-level
tolerance of tests/test_golden_c.py). The Morton-permuted resolve table
gives the same render bits as the original-order gather.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from raytracingc_tpu.cli import main as j_main
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.cli import main
from raytracingc_tpu_torch.ops import search
from raytracingc_tpu_torch.ops.intersect import with_perm_resolve
from raytracingc_tpu_torch.render.image import read_bmp
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene import builder as tb
from test_torch_accel import assert_accels_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_SCENE = os.path.join(REPO, "examples", "box_scene.txt")
SMALL = ["--triangles", BOX_SCENE, "-s", "16", "16", "--spp", "2", "-b", "3",
         "--tessellate", "4"]
ROUTES = {
    "brute": {"RTC_KERNEL": "brute"},
    "bitmask": {"RTC_BRUTE_MAX": "0"},
    "streamed": {"RTC_BRUTE_MAX": "0", "RTC_STREAM_MAX_T": "1024",
                 "RTC_STREAM_TILE": "768"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity renders run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loaders_attach_the_jax_accel(tmp_path):
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    assert_accels_equal(ts.accel, js.accel)
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvn 0 0 1\n"
                   "f 1/1/1 2/1/1 3/1/1\nf 2/1/1 4/1/1 3/1/1\n")
    assert_accels_equal(tb.scene_from_obj(str(obj)).accel,
                        jb.scene_from_obj(str(obj), use_native=False).accel)


def _cli(argv, env, monkeypatch, capsys):
    """Run the port CLI under ``env``; ``(traced rays, kernels called)``."""
    calls = set()
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        for name in ("search_brute", "search_bitmask", "search_packed"):
            real = getattr(search, name)

            def spy(*a, _real=real, _name=name, **k):
                calls.add(_name)
                return _real(*a, **k)

            m.setattr(search, name, spy)
        assert main(argv) == 0
    rays = int(re.search(r"rays=(\d+)", capsys.readouterr().out).group(1))
    return rays, calls


def test_cli_routes_render_the_same(tmp_path, monkeypatch, capsys):
    out = {}
    for name, env in ROUTES.items():
        path = str(tmp_path / f"{name}.bmp")
        rays, calls = _cli(SMALL + ["--device", "cpu", "-o", path, "--profile"],
                           env, monkeypatch, capsys)
        assert calls == {"search_packed" if name == "streamed"
                         else f"search_{name}"}, (name, calls)
        out[name] = (read_bmp(path), rays)
    ref = str(tmp_path / "jax.bmp")
    assert j_main(SMALL + ["-o", ref]) == 0
    want = read_bmp(ref)
    img, rays = out["brute"]
    assert rays > 500
    for name in ("bitmask", "streamed"):
        np.testing.assert_array_equal(out[name][0], img, err_msg=name)
        assert out[name][1] == rays, name
    assert abs(img.mean() / 255.0 - want.mean() / 255.0) <= 0.01


@pytest.fixture(scope="module")
def box_x4():
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    tt, n = tb.tessellate(ts.triangles, ts.n_triangles, levels=4)
    return dataclasses.replace(ts, triangles=tt, n_triangles=n,
                               accel=None).with_accel()


def test_linear_radiance_equal_across_routes(box_x4, monkeypatch):
    """The float radiance itself, not only the tonemapped bytes."""
    cam = Camera.look_at()
    got = {}
    for name, env in ROUTES.items():
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            got[name] = render(box_x4, cam, 12, 10, 2, 3, seed=5)
    img, n = got["brute"]
    for name in ("bitmask", "streamed"):
        assert torch.equal(got[name][0], img), name
        assert got[name][1] == n, name


def test_perm_resolve_render_bitwise(box_x4, monkeypatch):
    assert with_perm_resolve(box_x4).resolve_perm is None  # auto: < 500,000
    cam = Camera.look_at()
    monkeypatch.setenv("RTC_RESOLVE", "orig")
    a, na = render(box_x4, cam, 12, 10, 2, 3, seed=9)
    monkeypatch.setenv("RTC_RESOLVE", "perm")
    attached = with_perm_resolve(box_x4)
    assert attached.resolve_perm.shape == (box_x4.triangles.count, 17)
    b, nb = render(box_x4, cam, 12, 10, 2, 3, seed=9)
    assert torch.equal(a, b) and na == nb
    monkeypatch.setenv("RTC_RESOLVE", "permuted")
    with pytest.raises(ValueError, match="RTC_RESOLVE"):
        render(box_x4, cam, 4, 4, 1, 1)
