"""Port parity: scene loaders, padding, tessellation and the numpy bridge.

The loaders are numpy code in both packages, so every array must be EQUAL.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu.scene.obj_loader import load_obj as j_load_obj
from raytracingc_tpu.scene.triangles_txt import load_triangles_txt as j_load_txt
from raytracingc_tpu.scene.types import Spheres as JSpheres
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.scene.obj_loader import load_obj as t_load_obj
from raytracingc_tpu_torch.scene.triangles_txt import load_triangles_txt as t_load_txt
from raytracingc_tpu_torch.scene.types import Scene, Spheres

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")

OBJ = """\
# two faces, two materials, one unknown material name
mtllib tiny.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 1
vn 0 0 1
vn 0.6 0 0.8
usemtl glow
f 1/1/1 2/1/1 3/1/1
usemtl shiny
f 2/1/2 4/1/2 3/1/2 1/1/1
usemtl missing
f 3/1/1 2/1/2 4/1/2
"""
MTL = """\
newmtl glow
Kd 0.9 0.8 0.7
Ke 5 1 1
newmtl shiny
Kd 0.1 0.2 0.3
Ns 250
"""


def _jax_scene_np(js):
    return {
        "triangles": {f: np.asarray(getattr(js.triangles, f))
                      for f in bridge.TRIANGLE_FIELDS},
        "spheres": {f: np.asarray(getattr(js.spheres, f))
                    for f in bridge.SPHERE_FIELDS},
        "env": {f: np.asarray(getattr(js.env, f)) for f in bridge.ENV_FIELDS},
        "n_triangles": js.n_triangles,
        "n_spheres": js.n_spheres,
    }


def _assert_scene_equal(port_scene, jax_np):
    got = bridge.scene_to_numpy(port_scene)
    assert got["n_triangles"] == jax_np["n_triangles"]
    assert got["n_spheres"] == jax_np["n_spheres"]
    for part in ("triangles", "spheres", "env"):
        for f, v in jax_np[part].items():
            assert got[part][f].dtype == np.float32, (part, f)
            np.testing.assert_array_equal(got[part][f], v, err_msg=f"{part}.{f}")


def test_triangles_txt_loader_equal():
    for j, t in zip(j_load_txt(BOX_SCENE), t_load_txt(BOX_SCENE)):
        assert j.dtype == t.dtype == np.float32
        np.testing.assert_array_equal(t, j)


def test_obj_loader_equal(tmp_path):
    (tmp_path / "tiny.obj").write_text(OBJ)
    (tmp_path / "tiny.mtl").write_text(MTL)
    path = str(tmp_path / "tiny.obj")
    j, t = j_load_obj(path), t_load_obj(path)
    assert t.count == j.count == 3
    for f in ("verts", "normals", "albedo", "emission", "smoothness"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert [m.name for m in t.materials] == [m.name for m in j.materials]

    # Whole OBJ-mode scene: rotZ(180°), padding to 128, 8 empty spheres.
    js = jb.scene_from_obj(path, use_native=False)
    _assert_scene_equal(tb.scene_from_obj(path), _jax_scene_np(js))


def test_scene_from_triangles_txt_equal():
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    assert ts.triangles.count == 128 and ts.spheres.count == 8
    assert (ts.n_triangles, ts.n_spheres) == (10, 1)
    _assert_scene_equal(ts, _jax_scene_np(js))

    js0 = jb.scene_from_triangles_txt(BOX_SCENE, include_default_spheres=False,
                                      use_native=False)
    ts0 = tb.scene_from_triangles_txt(BOX_SCENE, include_default_spheres=False)
    _assert_scene_equal(ts0, _jax_scene_np(js0))


@pytest.mark.parametrize("n", [1, 8, 9])
def test_pad_spheres_equal(n):
    rs = np.random.default_rng(n)
    vals = dict(
        center=rs.normal(size=(n, 3)).astype(np.float32),
        radius=rs.uniform(0.5, 2, n).astype(np.float32),
        albedo=rs.uniform(size=(n, 3)).astype(np.float32),
        emission=rs.uniform(size=n).astype(np.float32),
        smoothness=rs.uniform(size=n).astype(np.float32),
    )
    jsph, jn = jb.pad_spheres(JSpheres(**{k: jnp.asarray(v) for k, v in vals.items()}))
    import torch

    tsph, tn = tb.pad_spheres(Spheres(**{k: torch.from_numpy(v) for k, v in vals.items()}))
    assert tn == jn == n and tsph.count == jsph.count == (8 if n <= 8 else 16)
    for f in bridge.SPHERE_FIELDS:
        np.testing.assert_array_equal(getattr(tsph, f).numpy(),
                                      np.asarray(getattr(jsph, f)), err_msg=f)


@pytest.mark.parametrize("levels", [1, 3])
def test_tessellate_equal(levels):
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    ts = tb.scene_from_triangles_txt(BOX_SCENE)
    jt, jn = jb.tessellate(js.triangles, js.n_triangles, levels=levels)
    tt, tn = tb.tessellate(ts.triangles, ts.n_triangles, levels=levels)
    assert tn == jn == 10 * 4**levels
    assert tt.count == jt.count
    for f in bridge.TRIANGLE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)


def test_bridge_round_trip():
    js = jb.scene_from_triangles_txt(BOX_SCENE)
    jnp_scene = _jax_scene_np(js)
    ts = bridge.scene_from_numpy(
        jnp_scene["triangles"], jnp_scene["spheres"], jnp_scene["env"],
        js.n_triangles, js.n_spheres,
    )
    assert isinstance(ts, Scene) and ts.accel is None and ts.resolve_perm is None
    _assert_scene_equal(ts, jnp_scene)
    # The port's own builder gives the same scene as the bridged one.
    _assert_scene_equal(tb.scene_from_triangles_txt(BOX_SCENE), jnp_scene)
    # The JAX scene's accel crosses with its MXU coefficient table, bit for
    # bit, and the port's own accel of the same scene packs the same table
    # (box_scene's coordinates round alike with or without FMA).
    assert js.accel is not None and js.accel.mxu_coeffs is not None
    ta = bridge.accel_from_numpy(bridge.accel_arrays(js.accel))
    want = np.asarray(js.accel.mxu_coeffs)
    assert ta.mxu_coeffs.dtype == torch.float32 and ta.mxu_coeffs.shape == (768, 16)
    np.testing.assert_array_equal(ta.mxu_coeffs.numpy(), want)
    np.testing.assert_array_equal(
        tb.scene_from_triangles_txt(BOX_SCENE).accel.mxu_coeffs.numpy(), want)
    with pytest.raises(KeyError):
        bridge.scene_from_numpy({}, jnp_scene["spheres"], jnp_scene["env"], 1, 1)
    with pytest.raises(ValueError):
        bridge.scene_from_numpy(jnp_scene["triangles"], jnp_scene["spheres"],
                                jnp_scene["env"], 129, 1)
