"""Port parity: the multi-rank layer over torch.distributed (gloo, the CPU).

Two worlds, of 2 and 4 ranks, run once each for this module: one child
process per rank (``tests/torch_parallel_worker.py``, torch on one thread,
its store on a free port, a timeout). Their inputs are made here by the JAX
package (``__graft_entry__._demo_scene``, ``examples/box_scene.txt``
tessellated with its accel and padded for blocks, a seeded soup with
duplicated triangles) and carried across as numpy. The results are held
here against:

* the port on one device: bit for bit where the sharding keeps every
  lane's arithmetic (pixels, blocks, the merged search winners), exactly
  against the port's own computation of a mean of per-rank means where it
  does not (samples), and within rtol 1e-5 of each leaf's largest gradient
  for the training step (a different association of the sample and pixel
  sums);
* the JAX package's sharded functions on the 8 virtual CPU devices of
  ``tests/conftest.py``: pixel- and block-sharded images within
  ``tests/test_parallel.py``'s 1e-6 (libm's log/cos and XLA's FMA
  contraction differ by ulps; observed 9.5e-7) with equal counts, sample
  sharding at distribution level (its rtol 0.05), the search winners
  exactly, and the training step's loss and gradients (recorded by an optax
  transformation before SGD) within rtol 1e-5 of each leaf's largest
  (observed 4.8e-6; the target is dimmed so that no residual is ulp noise).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_parallel_worker as worker
from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.camera import primary_rays as j_primary_rays
from raytracingc_tpu.ops.intersect import nearest_hit as j_nearest_hit
from raytracingc_tpu.parallel.mesh import make_mesh as j_make_mesh
from raytracingc_tpu.parallel.sharded import make_train_step as j_make_train_step
from raytracingc_tpu.parallel.sharded import pad_scene_for_blocks as j_pad_blocks
from raytracingc_tpu.parallel.sharded import render_sharded as j_render_sharded
from raytracingc_tpu.render.renderer import render as j_render
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu.scene.types import Scene as JScene
from raytracingc_tpu.scene.types import Spheres as JSpheres
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.camera import primary_rays
from raytracingc_tpu_torch.ops.intersect import nearest_hit
from raytracingc_tpu_torch.parallel import (
    make_mesh,
    make_train_step,
    mesh_for_strategy,
    pad_scene_for_blocks,
    render_sharded,
    render_sharded_blocks,
)
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.types import LEAF_PATHS, scene_leaves, with_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_SCENE = os.path.join(REPO, "examples", "box_scene.txt")
GRAD_RTOL = 1e-5  # of each leaf's largest |gradient|
WORLD_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_render.py: parity runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pack(prefix, js):
    """A JAX scene as the worker's numpy arrays."""
    host = lambda obj, fields: {f: np.asarray(getattr(obj, f)) for f in fields}
    return worker.pack_scene(
        prefix, host(js.triangles, bridge.TRIANGLE_FIELDS),
        host(js.spheres, bridge.SPHERE_FIELDS), host(js.env, bridge.ENV_FIELDS),
        js.n_triangles, js.n_spheres,
        None if js.accel is None else bridge.accel_arrays(js.accel))


def _soup():
    """384 live triangles facing rays along +z, rows 256..383 exact copies of
    rows 0..127 (distance ties between ranks' slices at 2 and 4 ranks), no
    sphere; and 1,024 rays through them."""
    rng = np.random.default_rng(20261017)
    n = 256
    a = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                  rng.uniform(-0.5, 0.5, n)], 1)
    b = a + rng.uniform(-0.3, 0.3, (n, 3))
    c = a + rng.uniform(-0.3, 0.3, (n, 3))
    verts = np.stack([a, b, c], 1).astype(np.float32)
    normal = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    normal *= -np.sign(normal[:, 2:3])  # facing -z: rays along +z hit them
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    verts = np.concatenate([verts, verts[:128]])
    normal = np.concatenate([normal, normal[:128]]).astype(np.float32)
    m = verts.shape[0]
    tris, n_live = jb.triangles_from_arrays(
        verts, normal, rng.uniform(0, 1, (m, 3)), np.zeros(m), np.zeros(m))
    spheres, _ = jb.pad_spheres(JSpheres.empty(), pad_to=8)  # 8 padding rows
    js = JScene.build(tris, spheres).replace(n_triangles=n_live, n_spheres=0)
    r = 1024
    o = np.stack([rng.uniform(-1.2, 1.2, r), rng.uniform(-1.2, 1.2, r),
                  np.full(r, -3.0)], 1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.05, r), rng.normal(0, 0.05, r), np.ones(r)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return js, o, d


def _box(levels=0):
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    if levels:
        tris, n = jb.tessellate(js.triangles, js.n_triangles, levels=levels)
        js = js.replace(triangles=tris, n_triangles=n, accel=None).with_accel()
    return js


@pytest.fixture(scope="module")
def jax_inputs():
    """The scenes of both worlds, built by the JAX package."""
    from __graft_entry__ import _demo_scene

    demo = _demo_scene()
    cam = JCamera.look_at()
    w, h, spp, b, seed = worker.TRAIN
    target, _ = j_render(demo, cam, w, h, spp=spp, max_bounce=b, seed=seed)
    target = target * 0.9  # no pixel matches already: every residual is a real one
    train = demo.replace(triangles=demo.triangles.replace(
        albedo=demo.triangles.albedo * 0.5))
    soup, o, d = _soup()
    return dict(demo=demo, cam=cam, box=_box(), box2=_box(levels=2),
                train=train, target=np.array(target).reshape(-1, 3),
                soup=soup, rays=(o, d))


def _blocks_scenes(ji, px):
    blk = j_pad_blocks(ji["box2"], px)
    soup = j_pad_blocks(ji["soup"].with_accel(), px)
    return blk, soup


def _inputs(ji, px) -> dict:
    blk, soup = _blocks_scenes(ji, px)
    out = {f"camera/{f}": np.asarray(getattr(ji["cam"], f))
           for f in bridge.CAMERA_FIELDS}
    for name, js in (("demo", ji["demo"]), ("box", ji["box"]),
                     ("train", ji["train"]), ("box_blocks", blk),
                     ("box_blocks_noaccel", blk.replace(accel=None)),
                     ("soup", soup), ("soup_noaccel", soup.replace(accel=None))):
        out.update(_pack(name, js))
    out["train/target"] = ji["target"]
    out["soup_rays/o"], out["soup_rays/d"] = ji["rays"]
    return out


def _run_world(tmp, size: int, inputs: dict) -> list:
    """Run the worker's cases in a world of ``size`` ranks; every rank's
    results."""
    np.savez(tmp / "inputs.npz", **inputs)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(size), str(port), str(tmp)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(size)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_PASS rank{r}" in out, (
            f"rank {r} of {size} failed (exit {p.returncode}):\n{out[-4000:]}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(size)]


@pytest.fixture(scope="module")
def worlds(jax_inputs, tmp_path_factory):
    """``{size: [rank 0's results, rank 1's, ...]}``."""
    return {n: _run_world(tmp_path_factory.mktemp(f"world{n}"), n,
                          _inputs(jax_inputs, n)) for n in (2, 4)}


@pytest.fixture(scope="module")
def port(jax_inputs):
    """``load(name, px)``: the port's scene of a world's inputs (through the
    worker's own codec), and the port's camera."""
    packed = {n: _inputs(jax_inputs, n) for n in (2, 4)}
    cam = bridge.camera_from_numpy(
        {f: np.asarray(getattr(jax_inputs["cam"], f)) for f in bridge.CAMERA_FIELDS})
    return (lambda name, px=2: worker.load_scene(packed[px], name)), cam


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _render(scene, cam, run, **kw):
    w, h, spp, b, seed = run
    img, n = render(scene, cam, w, h, spp, b, seed=seed, **kw)
    return img.numpy(), n


# ---------------------------------------------------------------------------
# Every rank returns the whole result.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_every_rank_returns_the_same_results(worlds, size):
    ranks = worlds[size]
    for r, res in enumerate(ranks[1:], 1):
        assert res.keys() == ranks[0].keys()
        for k, v in res.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=f"rank {r}: {k}")


# ---------------------------------------------------------------------------
# Pixels.
# ---------------------------------------------------------------------------

PX_CASES = [(2, "px", "demo", worker.PX), (4, "px", "demo", worker.PX),
            (4, "px_uneven", "demo", worker.PX_UNEVEN),
            (2, "px_box", "box", worker.PX)]
PX_IDS = ["2-demo", "4-demo", "4-demo-18x17", "2-box"]


@pytest.mark.parametrize("size,case,scene,run", PX_CASES, ids=PX_IDS)
def test_px_sharded_equals_render_bitwise(worlds, port, size, case, scene, run):
    load, cam = port
    want, n = _render(load(scene), cam, run)
    got = worlds[size][0]
    np.testing.assert_array_equal(_bits(got[f"{case}/image"]), _bits(want))
    assert int(got[f"{case}/count"]) == n


@pytest.mark.parametrize("size,case,scene,run", PX_CASES, ids=PX_IDS)
def test_px_sharded_matches_jax(worlds, jax_inputs, size, case, scene, run):
    w, h, spp, b, seed = run
    want, n = j_render_sharded(jax_inputs[scene], jax_inputs["cam"], w, h, spp=spp,
                               max_bounce=b, seed=seed,
                               mesh=j_make_mesh(px=size, spp=1))
    got = worlds[size][0]
    assert int(got[f"{case}/count"]) == int(n)
    # tests/test_parallel.py's bound between JAX's sharded and single renders
    # holds across the packages here (observed: 9.5e-7 on the demo scene).
    np.testing.assert_allclose(got[f"{case}/image"], np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Samples, and both dimensions.
# ---------------------------------------------------------------------------

SPP_CASES = [(2, "samples", 2), (4, "both", 2)]


@pytest.mark.parametrize("size,case,n_spp", SPP_CASES, ids=["samples-1x2", "both-2x2"])
def test_spp_sharded_equals_mean_of_offset_renders(worlds, port, size, case, n_spp):
    """Rank k of spp traces sample ids k * spp_per onwards; the mesh
    averages the ranks' means: exactly the sum of the offset renders over
    the spp size (a sum of two is order-free)."""
    load, cam = port
    w, h, spp, b, seed = worker.SAMPLES
    per = spp // n_spp
    parts = [render(load("demo"), cam, w, h, per, b, seed=seed,
                    sample_offset=k * per) for k in range(n_spp)]
    want = sum(img for img, _ in parts) / float(n_spp)
    got = worlds[size][0]
    np.testing.assert_array_equal(_bits(got[f"{case}/image"]), _bits(want.numpy()))
    assert int(got[f"{case}/count"]) == sum(n for _, n in parts)


@pytest.mark.parametrize("size,case", [(2, "jvp_samples"), (4, "jvp_both")],
                         ids=["samples-1x2", "both-2x2"])
def test_spp_sharded_jvp_equals_mean_of_offset_jvps(worlds, port, size, case):
    """torch.func.jvp of a sample-sharded render (production mode): the
    image and its tangent on every rank are the means of the one-device
    jvps of the offset renders, bit for bit (the spp mean's jvp is one
    all_reduce on the tangent, as JAX's pmean differentiates; the px
    gather's jvp gathers the tangents)."""
    load, cam = port
    scene = load("demo")
    w, h, spp, b, seed = worker.JVP
    tangents = worker.jvp_tangents(scene)
    leaves = {k: scene_leaves(scene)[k] for k in tangents}
    parts = [torch.func.jvp(
        lambda lv: render(with_leaves(scene, lv), cam, w, h, spp // 2, b, seed=seed,
                          sample_offset=k * (spp // 2))[0], (leaves,), (tangents,))
        for k in range(2)]
    got = worlds[size][0]
    for i, name in enumerate(("image", "tangent")):
        want = (parts[0][i] + parts[1][i]) / 2.0
        np.testing.assert_array_equal(_bits(got[f"{case}/{name}"]), _bits(want.numpy()))
    assert float(np.abs(got[f"{case}/tangent"]).max()) > 0


@pytest.mark.parametrize("size,case", [(2, "jacfwd_samples"), (4, "jacfwd_both")],
                         ids=["samples-1x2", "both-2x2"])
def test_spp_sharded_jacfwd_equals_mean_of_offset_jacfwds(worlds, port, size, case):
    """torch.func.jacfwd of a sample-sharded render (production mode): the
    Jacobian on every rank is the mean of the one-device Jacobians of the
    offset renders, bit for bit (the collectives' vmap rule runs them once
    per tangent direction, in the same order on every rank)."""
    load, cam = port
    scene = load("demo")
    w, h, spp, b, seed = worker.JVP
    p = worker.jacfwd_params(scene)
    parts = [torch.func.jacfwd(
        lambda q: render(worker.jacfwd_scene(scene, q), cam, w, h, spp // 2, b,
                         seed=seed, sample_offset=k * (spp // 2))[0])(p)
        for k in range(2)]
    want = (parts[0] + parts[1]) / 2.0
    for rank in worlds[size]:
        np.testing.assert_array_equal(_bits(rank[f"{case}/jacobian"]),
                                      _bits(want.numpy()))
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("size,case,n_spp", SPP_CASES, ids=["samples-1x2", "both-2x2"])
def test_spp_sharded_matches_jax_distribution(worlds, jax_inputs, size, case, n_spp):
    """tests/test_parallel.py's rule: image means agree to Monte-Carlo
    tolerance with JAX's sharded render on the same mesh."""
    w, h, spp, b, seed = worker.SAMPLES
    want, _ = j_render_sharded(jax_inputs["demo"], jax_inputs["cam"], w, h, spp=spp,
                               max_bounce=b, seed=seed,
                               mesh=j_make_mesh(px=size // n_spp, spp=n_spp))
    np.testing.assert_allclose(worlds[size][0][f"{case}/image"].mean(),
                               np.asarray(want).mean(), rtol=0.05)


# ---------------------------------------------------------------------------
# The training step.
# ---------------------------------------------------------------------------

TRAIN_CASES = [(2, "train_1x2", (1, 2)), (4, "train_2x2", (2, 2))]


def _assert_grads_close(got: dict, want: dict):
    for k in LEAF_PATHS:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)


def _single_device_step(scene, cam):
    w, h, spp, b, seed = worker.TRAIN
    o, d = primary_rays(cam, w, h)
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in scene_leaves(scene).items()}
    opt = torch.optim.SGD(list(params.values()), lr=worker.TRAIN_LR)
    return params, make_train_step(None, opt, spp=spp, max_bounce=b, seed=seed), o, d


@pytest.mark.parametrize("size,case,shape", TRAIN_CASES, ids=["1x2", "2x2"])
def test_train_step_matches_single_device(worlds, port, jax_inputs, size, case, shape):
    """The mesh's loss and gradients are the whole image's: the
    single-device step's up to the association of the sums; the update the
    ranks applied is SGD of exactly the gradients they report."""
    load, cam = port
    params, step, o, d = _single_device_step(load("train"), cam)
    w, h = worker.TRAIN[:2]
    _, loss = step(load("train"), params, o, d, torch.arange(w * h),
                   torch.from_numpy(jax_inputs["target"]))
    got = worlds[size][0]
    np.testing.assert_allclose(float(got[f"{case}/loss"]), loss, rtol=1e-6)
    _assert_grads_close({k: got[f"{case}/grad{k}"] for k in LEAF_PATHS},
                        {k: t.grad.numpy() for k, t in params.items()})
    start = scene_leaves(load("train"))
    for k in LEAF_PATHS:  # SGD's own arithmetic: p + (-lr) * g
        want = torch.add(start[k], torch.from_numpy(got[f"{case}/grad{k}"]),
                         alpha=-worker.TRAIN_LR)
        np.testing.assert_array_equal(got[f"{case}/leaf{k}"], want.numpy(), err_msg=k)


def _record():
    """An optax transformation whose state is the gradients it was given."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.mark.parametrize("size,case,shape", TRAIN_CASES, ids=["1x2", "2x2"])
def test_train_step_matches_jax(worlds, jax_inputs, size, case, shape):
    """JAX's make_train_step on the same mesh shape, its gradients recorded
    before optax SGD, against the port's before torch.optim.SGD: the
    gradients themselves (an Adam comparison would hide their scale) and the
    updated leaves."""
    w, h, spp, b, seed = worker.TRAIN
    js, cam = jax_inputs["train"], jax_inputs["cam"]
    opt = optax.chain(_record(), optax.sgd(worker.TRAIN_LR))
    step = j_make_train_step(j_make_mesh(px=shape[0], spp=shape[1]), opt, spp=spp,
                             max_bounce=b, seed=seed)
    o, d = j_primary_rays(cam, w, h)
    new, state, loss = step(js, opt.init(js), o, d,
                            jnp.arange(w * h, dtype=jnp.uint32),
                            jnp.asarray(jax_inputs["target"]))
    got = worlds[size][0]
    np.testing.assert_allclose(float(got[f"{case}/loss"]), float(loss), rtol=1e-5)
    grads = bridge.leaf_arrays(state[0])
    _assert_grads_close({k: got[f"{case}/grad{k}"] for k in LEAF_PATHS}, grads)
    want = bridge.leaf_arrays(new)
    for k in LEAF_PATHS:  # the gradients' bound through SGD, plus rounding
        atol = (worker.TRAIN_LR * GRAD_RTOL * float(np.abs(grads[k]).max())
                + 1e-6 * max(float(np.abs(want[k]).max()), 1.0))
        np.testing.assert_allclose(got[f"{case}/leaf{k}"], want[k], rtol=0,
                                   atol=atol, err_msg=k)


def test_one_rank_mesh_step_is_the_single_device_step(port, jax_inputs):
    """In a world of one rank (this process), make_train_step on the mesh
    equals the step without one (fit_scene's), loss and gradients bit for
    bit."""
    load, cam = port
    w, h = worker.TRAIN[:2]
    target = torch.from_numpy(jax_inputs["target"])
    out = []
    for mesh in (None, make_mesh(1, 1, device_type="cpu")):
        params, _, o, d = _single_device_step(load("train"), cam)
        opt = torch.optim.SGD(list(params.values()), lr=worker.TRAIN_LR)
        step = make_train_step(mesh, opt, spp=worker.TRAIN[2],
                               max_bounce=worker.TRAIN[3], seed=worker.TRAIN[4])
        _, loss = step(load("train"), params, o, d, torch.arange(w * h), target)
        out.append((loss, {k: t.grad for k, t in params.items()}))
    assert out[0][0] == out[1][0]
    for k in LEAF_PATHS:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_fit_scene_mesh_takes_a_step(worlds, port, jax_inputs):
    """fit_scene(mesh=) on 2 px ranks: the single-device fit's loss and
    albedo (SGD), up to the association of the pixel sums."""
    from raytracingc_tpu_torch.diff import fit_scene

    load, cam = port
    w, h, spp, b, seed = worker.TRAIN
    fitted, losses = fit_scene(
        load("train"), torch.from_numpy(jax_inputs["target"]).reshape(h, w, 3), cam,
        steps=worker.FIT_STEPS, spp=spp, max_bounce=b, seed=seed,
        trainable=["albedo"], optimizer=lambda ps: torch.optim.SGD(ps, lr=worker.TRAIN_LR))
    got = worlds[2][0]
    np.testing.assert_allclose(got["fit/losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(got["fit/albedo"], fitted.triangles.albedo.numpy(),
                               rtol=0, atol=1e-6)
    assert not np.array_equal(got["fit/albedo"], load("train").triangles.albedo.numpy())


# ---------------------------------------------------------------------------
# Progressive, in-process one-rank worlds, the CLI, the dryrun.
# ---------------------------------------------------------------------------


def test_progressive_sharded_matches_oneshot(worlds, port):
    """tests/test_parallel.py::test_progressive_sharded_matches_oneshot."""
    load, cam = port
    want, n = _render(load("demo"), cam, worker.PROGRESSIVE)
    got = worlds[2][0]
    np.testing.assert_allclose(got["progressive/image"], want, rtol=2e-6, atol=2e-7)
    assert int(got["progressive/count"]) == n


def test_progressive_samples_validates_every_batch(worlds):
    """With samples sharded over 2 ranks, spp 5 in batches of 2 leaves a
    batch of 1: refused up front on every rank, as in the JAX package."""
    assert all(bool(r["progressive_bad_batch/raised"]) for r in worlds[2])


@pytest.mark.parametrize("strategy", ["pixels", "samples"])
def test_one_rank_render_sharded_is_render(port, strategy):
    """Without a world, render_sharded runs in a world of one rank (this
    process): the single-device render bit for bit."""
    load, cam = port
    w, h, spp, b, seed = worker.PX
    got, n = render_sharded(load("demo"), cam, w, h, spp, b, seed=seed,
                            strategy=strategy)
    want, m = _render(load("demo"), cam, worker.PX)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert n == m


def test_implicit_world_builds_each_mesh_once(port):
    """Without a world, make_mesh starts a world of one rank (this process)
    that gives each device type its own backend, gloo for the CPU (where
    torch has NCCL, CUDA tensors take it, never gloo); a mesh is built once
    per world and shape, render_sharded without a mesh reuses it, and a new
    world builds its own."""
    import torch.distributed as dist

    from raytracingc_tpu_torch.parallel import mesh as pmesh

    if dist.is_initialized():
        dist.destroy_process_group()
    a = make_mesh(1, 1, device_type="cpu")
    assert dist.group.WORLD is pmesh._IMPLICIT
    want = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
    assert dist.get_backend() == want
    assert make_mesh(1, 1, device_type="cpu") is a
    assert mesh_for_strategy("samples", device_type="cpu") is a
    load, cam = port
    render_sharded(load("demo"), cam, 4, 4, 1, 1)
    assert make_mesh(device_type="cpu") is a
    dist.destroy_process_group()
    b = make_mesh(1, 1, device_type="cpu")
    assert b is not a and make_mesh(1, 1, device_type="cpu") is b


def test_render_sharded_reverse_mode_raises(port):
    """Reverse mode through render_sharded raises (its gradients would be
    per rank, in make_train_step's convention); forward mode through the
    same call on a one-rank mesh gives the one-device jvp bit for bit."""
    load, cam = port
    scene = load("demo")
    mesh = make_mesh(1, 1, device_type="cpu")
    leaves = {".triangles.albedo": scene_leaves(scene)[".triangles.albedo"]}
    tangents = {k: torch.ones_like(t) for k, t in leaves.items()}
    albedo = leaves[".triangles.albedo"].clone().requires_grad_(True)
    img, _ = render_sharded(with_leaves(scene, {".triangles.albedo": albedo}), cam,
                            4, 4, spp=2, max_bounce=2, mesh=mesh, strategy="samples",
                            early_exit=False)
    with pytest.raises(RuntimeError, match="make_train_step"):
        img.sum().backward()
    fn = lambda sharded: lambda lv: (render_sharded if sharded else render)(
        with_leaves(scene, lv), cam, 4, 4, 2, 2,
        **({"mesh": mesh, "strategy": "samples"} if sharded else {}))[0]
    got = torch.func.jvp(fn(True), (leaves,), (tangents,))
    want = torch.func.jvp(fn(False), (leaves,), (tangents,))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))


@pytest.mark.parametrize("strategy", ["pixels", "samples"])
def test_one_rank_render_sharded_jacfwd_is_render(port, strategy):
    """torch.func.jacfwd through render_sharded on a one-rank mesh: the
    one-device Jacobian bit for bit, in production mode and in the
    differentiable fast forward."""
    load, cam = port
    scene = load("demo")
    mesh = make_mesh(1, 1, device_type="cpu")
    p = worker.jacfwd_params(scene)
    for early_exit in (True, False):
        fn = lambda sharded: lambda q: (render_sharded if sharded else render)(
            worker.jacfwd_scene(scene, q), cam, 6, 5, 2, 3, early_exit=early_exit,
            **({"mesh": mesh, "strategy": strategy} if sharded else {}))[0]
        got = torch.func.jacfwd(fn(True))(p)
        want = torch.func.jacfwd(fn(False))(p)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
        assert float(want.abs().max()) > 0


def test_dryrun_multichip_four_ranks(worlds):
    """The port's dryrun_multichip(4) ran on every rank of the 4-rank world
    (it raises on a non-finite loss or a broken blocks identity)."""
    got = worlds[4][0]
    assert np.isfinite(got["dryrun/loss"]) and int(got["dryrun/rays"]) > 0
    assert int(got["dryrun/blocks_rays"]) == int(got["dryrun/rays"])


def test_cli_shard_pixels_two_processes(tmp_path, capsys):
    """Two CLI processes with --shard pixels write the single-device CLI's
    BMP, byte for byte, with the same traced rays; rank 1 writes nothing."""
    from raytracingc_tpu_torch.cli import main

    flags = ["--device", "cpu", "--triangles", BOX_SCENE, "-s", "20", "12",
             "--spp", "2", "-b", "3", "--profile"]
    one = tmp_path / "one.bmp"
    main(flags + ["-o", str(one)])
    rays = lambda out: [ln.split("rays=")[1].split()[0] for ln in out.splitlines()
                        if ln.startswith("[profile]")]
    want = rays(capsys.readouterr().out)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raytracingc_tpu_torch.cli", *flags,
         "--shard", "pixels", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r),
         "-o", str(tmp_path / f"px{r}.bmp")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    assert (tmp_path / "px0.bmp").read_bytes() == one.read_bytes()
    assert not (tmp_path / "px1.bmp").exists()
    assert want and rays(outs[0]) == want and not rays(outs[1])


# ---------------------------------------------------------------------------
# Block-sharded scenes.
# ---------------------------------------------------------------------------

BLOCK_CASES = [(n, v) for n in (2, 4) for v in ("accel", "trivial", "range")]
BLOCK_IDS = [f"{n}-{v}" for n, v in BLOCK_CASES]


@pytest.mark.parametrize("size,variant", BLOCK_CASES, ids=BLOCK_IDS)
def test_blocks_equal_replicated_render(worlds, port, size, variant):
    """Each rank holds 1/size of the triangles and traces every ray (the
    packet routes on its slice: the scene's accel, a trivial accel whose
    local indices are made global, or the range kernel under RTC_CULL=range);
    the image is the replicated render's, bit for bit."""
    load, cam = port
    want, n = _render(load("box_blocks", size), cam, worker.BLOCKS)
    got = worlds[size][0]
    np.testing.assert_array_equal(_bits(got[f"blocks_{variant}/image"]), _bits(want))
    assert int(got[f"blocks_{variant}/count"]) == n


@pytest.mark.parametrize("size,variant", BLOCK_CASES, ids=BLOCK_IDS)
def test_blocks_match_jax(worlds, jax_inputs, size, variant):
    """JAX's render_sharded_blocks on a px mesh of the same size and the
    same padded scene (the in-repo counterpart of
    tests/test_round4_fixes.py's block-sharding cases)."""
    from raytracingc_tpu.parallel.sharded import render_sharded_blocks as j_blocks

    w, h, spp, b, seed = worker.BLOCKS
    blk, _ = _blocks_scenes(jax_inputs, size)
    want, n = j_blocks(blk, jax_inputs["cam"], w, h, spp, b, seed=seed,
                       mesh=j_make_mesh(px=size, spp=1))
    got = worlds[size][0]
    assert int(got[f"blocks_{variant}/count"]) == int(n)
    np.testing.assert_allclose(got[f"blocks_{variant}/image"], np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,variant", BLOCK_CASES, ids=BLOCK_IDS)
def test_blocks_merged_winners_are_exact(worlds, port, jax_inputs, size, variant):
    """The ranks' winners merged across px equal a whole-scene search: hit,
    kind and original index, ties between copies in different ranks' slices
    going to the lower index; the indices also equal JAX's."""
    load, _ = port
    o, d = (torch.from_numpy(x) for x in jax_inputs["rays"])
    want = nearest_hit(o, d, load("soup", size))
    got = worlds[size][0]
    case = f"merge_{variant}"
    for f in ("hit", "is_tri", "idx"):
        np.testing.assert_array_equal(got[f"{case}/{f}"], getattr(want, f).numpy(),
                                      err_msg=f)
    tri = want.is_tri & want.hit
    assert int(tri.sum()) > 100
    assert int((want.idx[tri] < 128).sum()) > 0  # winners that have a copy
    assert int((want.idx[tri] >= 256).sum()) == 0  # every tie went to the original
    _, soup = _blocks_scenes(jax_inputs, size)
    ref = j_nearest_hit(jnp.asarray(jax_inputs["rays"][0]),
                        jnp.asarray(jax_inputs["rays"][1]), soup)
    np.testing.assert_array_equal(got[f"{case}/idx"], np.asarray(ref.idx))


def test_blocks_on_both_dimensions(worlds, port):
    """Blocks over px = 2 with spp = 2 on 4 ranks: the mean of the two
    offset replicated renders, bit for bit; the count sums spp only."""
    load, cam = port
    w, h, spp, b, seed = worker.BLOCKS
    parts = [render(load("box_blocks", 4), cam, w, h, spp // 2, b, seed=seed,
                    sample_offset=k * spp // 2) for k in range(2)]
    want = (parts[0][0] + parts[1][0]) / 2.0
    got = worlds[4][0]
    np.testing.assert_array_equal(_bits(got["blocks_both/image"]), _bits(want.numpy()))
    assert int(got["blocks_both/count"]) == parts[0][1] + parts[1][1]


@pytest.mark.parametrize("n", [2, 4])
def test_pad_scene_for_blocks_matches_jax_and_is_inert(port, jax_inputs, n):
    """The port's padding equals JAX's array for array (the rebuilt accel
    too), and a render of the padded scene is the original's bits."""
    load, cam = port
    box2 = load("box_blocks", 2)  # 256 rows: 2 blocks
    padded = pad_scene_for_blocks(box2, n)
    assert padded.triangles.count % (n * 128) == 0
    assert padded.n_triangles == box2.n_triangles
    want = load("box_blocks", n)
    for k, v in scene_leaves(want).items():
        assert torch.equal(scene_leaves(padded)[k], v), k
    for f in ("orig_idx", "aabb_lo", "aabb_hi", "perm_of_orig", "packed_plane"):
        assert torch.equal(getattr(padded.accel, f), getattr(want.accel, f)), f
    a, na = _render(box2, cam, worker.BLOCKS)
    b, nb = _render(padded, cam, worker.BLOCKS)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert na == nb


def test_pad_scene_for_blocks_non_multiple_count(port):
    """A count that is no multiple of 128 rounds up to blocks first (the JAX
    package's review-r4 fix), and the padded scene renders the same bits;
    the block-sharded render refuses the unpadded count."""
    import dataclasses

    from raytracingc_tpu_torch.scene.types import Triangles

    load, cam = port
    box = load("box_blocks_noaccel", 4)  # 512 rows
    tris = Triangles(**{f.name: getattr(box.triangles, f.name)[:300]
                        for f in dataclasses.fields(Triangles)})
    scene = dataclasses.replace(box, triangles=tris)
    padded = pad_scene_for_blocks(scene, 2)
    assert padded.triangles.count == 512 and padded.n_triangles == scene.n_triangles
    a, na = _render(scene, cam, worker.BLOCKS)
    b, nb = _render(padded, cam, worker.BLOCKS)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert na == nb
    with pytest.raises(ValueError, match="pad_scene_for_blocks"):
        render_sharded_blocks(scene, cam, 4, 4, 1, 1,
                              mesh=make_mesh(1, 1, device_type="cpu"))
