"""Port parity: the native C++ scene loader and the objtest entry point.

The port builds ``native/rtc_loader.cpp`` with g++ into its own build
directory (``raytracingc_tpu_torch/scene/native.py``). Its arrays must EQUAL
the port's Python parsers' and the JAX package's native loader's, bit for
bit, on ``examples/box_scene.txt`` and on OBJ + MTL files written here.
"""

import os
import shutil

import numpy as np
import pytest

from raytracingc_tpu.scene import native as j_native
from raytracingc_tpu_torch import objtest
from raytracingc_tpu_torch.ops import _build
from raytracingc_tpu_torch.scene import native
from raytracingc_tpu_torch.scene.builder import scene_from_obj
from raytracingc_tpu_torch.scene.obj_loader import load_obj
from raytracingc_tpu_torch.scene.triangles_txt import load_triangles_txt

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")

# Three faces: a material with emission, a mirror-ish one (Ns), an unknown
# name (the default material); a quad truncated to its first three groups.
OBJ = """\
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 1
v -1 2 0.5
vn 0 0 1
vn 0.6 0 0.8
vn 0 1 0
usemtl glow
f 1/1/1 2/1/1 3/1/1
usemtl shiny
f 2/1/2 4/1/2 3/1/2 1/1/1
usemtl missing
f 3/1/3 5/1/3 4/1/2
"""
MTL = """\
newmtl glow
Kd 0.9 0.8 0.7
Ke 5 1 1
newmtl shiny
Kd 0.1 0.2 0.3
Ns 250
"""
FIELDS = ("verts", "normals", "albedo", "emission", "smoothness")


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native loader cannot be built")
    assert native.build(), native.build_error
    return native.library_path()


@pytest.fixture
def obj_file(tmp_path):
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "scene.mtl").write_text(MTL)
    return str(tmp_path / "scene.obj")


def _assert_equal(got, want):
    assert len(got) == len(want) == 5
    for f, g, w in zip(FIELDS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype == np.float32, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_builds_into_the_port_build_directory(built):
    assert built.exists() and built.parent == _build.BUILD_DIR
    assert built.parent.name == "raytracingc_tpu_torch"
    assert native.SOURCE.name == "rtc_loader.cpp"
    assert native.available()


def test_triangles_txt_equal(built):
    got = native.load_triangles_txt_native(BOX_SCENE)
    _assert_equal(got, load_triangles_txt(BOX_SCENE))
    if j_native.available():
        _assert_equal(got, j_native.load_triangles_txt_native(BOX_SCENE))


def test_obj_with_mtl_equal(built, obj_file):
    got = native.load_obj_native(obj_file)
    mesh = load_obj(obj_file)
    _assert_equal(got, [getattr(mesh, f) for f in FIELDS])
    assert got[0].shape == (3, 3, 3)
    assert got[3][0] == 5.0 and got[4][1] == np.float32(np.sqrt(0.001 * 250))
    np.testing.assert_array_equal(got[2][2], [1.0, 1.0, 1.0])  # unknown: default
    if j_native.available():
        _assert_equal(got, j_native.load_obj_native(obj_file))


def test_missing_mtl_gives_default_materials(built, tmp_path):
    p = tmp_path / "nomtl.obj"
    p.write_text(OBJ.replace("scene.mtl", "absent.mtl"))
    v, n, a, e, s = native.load_obj_native(str(p))
    assert v.shape == (3, 3, 3)
    assert (a == 1.0).all() and (e == 0.0).all() and (s == 0.0).all()
    mesh = load_obj(str(p))
    _assert_equal((v, n, a, e, s), [getattr(mesh, f) for f in FIELDS])


def test_error_paths(built, tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_obj_native(str(tmp_path / "absent.obj"))
    with pytest.raises(FileNotFoundError):
        native.load_triangles_txt_native(str(tmp_path / "absent.txt"))
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    with pytest.raises(ValueError, match="69"):
        native.load_obj_native(str(bad))
    with pytest.raises(ValueError):
        load_obj(str(bad))


def test_scene_from_obj_native_and_python_equal(built, obj_file):
    sn = scene_from_obj(obj_file, use_native=True)
    sp = scene_from_obj(obj_file, use_native=False)
    sd = scene_from_obj(obj_file)  # None: the native loader, as it builds
    assert sn.n_triangles == sp.n_triangles == sd.n_triangles == 3
    for f in ("a", "b", "c", "normal", "albedo", "emission", "smoothness"):
        for s in (sn, sd):
            np.testing.assert_array_equal(getattr(s.triangles, f).numpy(),
                                          getattr(sp.triangles, f).numpy(), err_msg=f)


def test_use_native_true_without_a_loader_raises(monkeypatch, obj_file):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native loader requested"):
        scene_from_obj(obj_file, use_native=True)
    assert scene_from_obj(obj_file).n_triangles == 3  # None: the Python parser


@pytest.mark.parametrize("loader", ["--native", "--python"])
def test_objtest_exit_codes(built, obj_file, tmp_path, capsys, loader):
    assert objtest.main([obj_file, loader]) == 0
    out = capsys.readouterr().out
    assert f"{obj_file}: 3 triangles" in out and "emissive triangles: 1" in out
    assert ("native C++ loader" in out) == (loader == "--native")
    if loader == "--python":
        assert "material 'glow'" in out
    assert objtest.main([BOX_SCENE, "--txt", loader]) == 0
    assert "10 triangles" in capsys.readouterr().out
    assert objtest.main([str(tmp_path / "absent.obj"), loader]) == 1
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    assert objtest.main([str(bad), loader]) == 1
    assert "ERROR" in capsys.readouterr().err
