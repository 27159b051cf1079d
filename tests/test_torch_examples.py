"""The port's four inverse-rendering examples on the CPU.

Each runs at the step count and meets the bar of its JAX test
(``tests/test_diff.py``: vertices 60 steps, camera 120, sphere 150; the
albedo example at its default 80 steps exits 0, its wall's albedo error
fallen), and each builds its scene exactly as the JAX example does: the
same arrays, live counts and accel (the JAX example modules, imported from
``examples/``, build the reference scenes).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingc_tpu.scene.builder import scene_from_triangles_txt as j_from_txt
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.examples import demo
from raytracingc_tpu_torch.examples import inverse_albedo as albedo_ex
from raytracingc_tpu_torch.examples import inverse_camera as camera_ex
from raytracingc_tpu_torch.examples import inverse_sphere as sphere_ex
from raytracingc_tpu_torch.examples import inverse_vertices as vertices_ex
from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
from raytracingc_tpu_torch.tools import BOX_SCENE
from test_torch_accel import assert_accels_equal

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def assert_scenes_equal(got, want):
    """The port scene's arrays, live counts and accel are the JAX scene's."""
    arrays = bridge.scene_to_numpy(got)
    for group, fields in (("triangles", bridge.TRIANGLE_FIELDS),
                          ("spheres", bridge.SPHERE_FIELDS),
                          ("env", bridge.ENV_FIELDS)):
        for f in fields:
            np.testing.assert_array_equal(arrays[group][f],
                                          np.asarray(getattr(getattr(want, group), f)),
                                          err_msg=f"{group}.{f}")
    assert (got.n_triangles, got.n_spheres) == (want.n_triangles, want.n_spheres)
    assert (got.accel is None) == (want.accel is None)
    if got.accel is not None:
        assert_accels_equal(got.accel, want.accel)


def test_scenes_match_the_jax_examples():
    from __graft_entry__ import _demo_scene

    assert_scenes_equal(demo.demo_scene(), _demo_scene())
    j_sphere, j_vertices = _jax_example("inverse_sphere"), _jax_example("inverse_vertices")
    for offset in ((0.0, 0.0, 0.0), (0.15, -0.12, 0.2)):
        assert_scenes_equal(sphere_ex.make_scene(offset), j_sphere.make_scene(offset))
    for dz in (0.0, 0.08):
        assert_scenes_equal(vertices_ex.make_scene(dz), j_vertices.make_scene(dz))


def test_albedo_corruption_matches_jax():
    """WALL_NOISE is the JAX example's jax.random draw, and the corrupted
    scene's albedo (every row clipped) is the JAX example's bit for bit."""
    truth = j_from_txt(BOX_SCENE, use_native=False)
    noise = jax.random.uniform(jax.random.PRNGKey(0), truth.triangles.albedo.shape,
                               minval=-0.35, maxval=0.35)
    np.testing.assert_array_equal(np.asarray(noise)[albedo_ex.WALL],
                                  np.array(albedo_ex.WALL_NOISE, np.float32))
    wall = jnp.zeros_like(truth.triangles.albedo).at[2:4].set(1.0)
    want = jnp.clip(truth.triangles.albedo + noise * wall, 0.02, 0.98)
    got = albedo_ex.corrupt(scene_from_triangles_txt(BOX_SCENE)).triangles.albedo
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("example", ["albedo", "camera", "sphere", "vertices"])
def test_examples_default_to_the_card(monkeypatch, example):
    """Each example's ``main`` runs on the card unless asked for the CPU: its
    default device is cuda, and without a card it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"albedo": albedo_ex, "camera": camera_ex, "sphere": sphere_ex,
           "vertices": vertices_ex}[example]
    call = (lambda: mod.main([])) if example == "albedo" else (lambda: mod.main(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_inverse_albedo_recovers(tmp_path):
    """examples/inverse_albedo.py's own bar at its defaults (80 steps): exit
    0, the wall's albedo error fell; it writes its three images."""
    assert albedo_ex.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    assert sorted(os.listdir(tmp_path)) == ["corrupted.png", "recovered.png",
                                            "target.png"]


def test_inverse_vertices_recovers():
    """tests/test_diff.py::test_vertex_geometry_recovery_end_to_end."""
    losses, l1_0, l1_1 = vertices_ex.main(steps=60, device="cpu")
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])
    assert l1_1 < 0.25 * l1_0, (l1_0, l1_1)


def test_inverse_camera_recovers():
    """tests/test_diff.py::test_camera_pose_recovery_end_to_end."""
    losses, e0, e1 = camera_ex.main(steps=120, device="cpu")
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    assert e1 < 0.25 * e0, (e0, e1)


def test_inverse_sphere_recovers():
    """tests/test_diff.py::test_sphere_center_recovery_end_to_end."""
    losses, c0, c1 = sphere_ex.main(steps=150, device="cpu")
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    assert c1 < 0.25 * c0, (c0, c1)
