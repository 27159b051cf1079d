"""One rank of a gloo world for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK SIZE PORT DIR

Joins a world of SIZE ranks on the CPU (gloo, store at 127.0.0.1:PORT),
reads ``DIR/inputs.npz`` (scenes, camera, rays and targets that the test
made with the JAX package and carried as numpy under ``bridge``'s field
names, see :func:`pack_scene`), runs the cases of ``CASES[SIZE]`` and writes
every array they return to ``DIR/rank{RANK}.npz`` as ``case/name``. Prints
``WORKER_PASS rank{RANK}`` at the end. Imports the port only, no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from raytracingc_tpu_torch import bridge  # noqa: E402
from raytracingc_tpu_torch.camera import primary_rays  # noqa: E402

# The runs, shared with the test: (width, height, spp, max_bounce, seed).
PX = (16, 16, 2, 3, 3)
PX_UNEVEN = (18, 17, 2, 3, 0)  # 306 px: 306 % 4 == 2, padding lanes
SAMPLES = (16, 16, 16, 3, 3)
JVP = (8, 8, 4, 3, 3)  # the forward-mode renders (samples, both)
PROGRESSIVE = (16, 16, 4, 2, 9)
PROGRESSIVE_BATCH = 2
BLOCKS = (16, 16, 2, 3, 5)
TRAIN = (8, 8, 4, 2, 7)
TRAIN_LR = 0.5
FIT_STEPS = 1


def pack_scene(prefix: str, tri: dict, sph: dict, env: dict, n_triangles: int,
               n_spheres: int, accel: dict | None = None) -> dict:
    """A scene as flat numpy arrays ``prefix/group/field``; ``accel`` is
    ``bridge.accel_arrays``' dict (absent fields are None)."""
    out = {f"{prefix}/n": np.array([n_triangles, n_spheres])}
    for group, arrays in (("triangles", tri), ("spheres", sph), ("env", env)):
        out.update({f"{prefix}/{group}/{k}": np.asarray(v) for k, v in arrays.items()})
    if accel is not None:
        out.update({f"{prefix}/accel_tri/{k}": np.asarray(v)
                    for k, v in accel["triangles"].items()})
        out.update({f"{prefix}/accel/{k}": np.asarray(accel[k])
                    for k in bridge.ACCEL_FIELDS if accel[k] is not None})
    return out


def load_scene(data, prefix: str):
    """The port scene :func:`pack_scene` wrote under ``prefix`` (``data``: the
    npz file or the dict it was written from)."""
    group = lambda g: {k.rsplit("/", 1)[1]: data[k] for k in data
                       if k.startswith(f"{prefix}/{g}/")}
    n_t, n_s = (int(x) for x in data[f"{prefix}/n"])
    scene = bridge.scene_from_numpy(group("triangles"), group("spheres"),
                                    group("env"), n_t, n_s)
    acc = group("accel")
    if not acc:
        return scene
    arrays = {k: acc.get(k) for k in bridge.ACCEL_FIELDS}
    arrays["triangles"] = group("accel_tri")
    return dataclasses.replace(scene, accel=bridge.accel_from_numpy(arrays))


@functools.cache
def _mesh(px: int, spp: int):
    """One mesh of each shape per world (each builds process groups)."""
    from raytracingc_tpu_torch.parallel import make_mesh

    return make_mesh(px, spp, device_type="cpu")


def _camera(data):
    return bridge.camera_from_numpy(
        {f: data[f"camera/{f}"] for f in bridge.CAMERA_FIELDS})


@contextlib.contextmanager
def _knobs(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _image(fn):
    img, n = fn()
    return {"image": img.numpy(), "count": np.array(n)}


def case_render(data, size, scene, run, strategy=None, mesh_shape=None,
                scene_sharding="replicated", knobs=None):
    from raytracingc_tpu_torch.parallel import render_sharded

    w, h, spp, b, seed = run
    mesh = _mesh(*mesh_shape) if mesh_shape else None
    with _knobs(**(knobs or {})):
        return _image(lambda: render_sharded(
            load_scene(data, scene), _camera(data), w, h, spp=spp, max_bounce=b,
            seed=seed, strategy=strategy or "pixels", mesh=mesh,
            scene_sharding=scene_sharding))


def jvp_tangents(scene) -> dict:
    """The forward-mode cases' tangents: ones on the triangles' albedo and
    emission and on the environment's ground colour."""
    from raytracingc_tpu_torch.scene.types import scene_leaves

    return {k: torch.ones_like(t) for k, t in scene_leaves(scene).items()
            if k in (".triangles.albedo", ".triangles.emission", ".env.ground")}


def case_jvp(data, size, strategy):
    """torch.func.jvp of a sharded render (production mode) along
    :func:`jvp_tangents`: the image, its tangent and the traced rays."""
    from raytracingc_tpu_torch.parallel import render_sharded
    from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

    w, h, spp, b, seed = JVP
    scene = load_scene(data, "demo")
    tangents = jvp_tangents(scene)
    leaves = {k: scene_leaves(scene)[k] for k in tangents}
    def fn(lv):
        img, n = render_sharded(with_leaves(scene, lv), _camera(data), w, h,
                                spp=spp, max_bounce=b, seed=seed,
                                strategy=strategy, mesh=_mesh(size // 2, 2))
        return img, torch.tensor(n)  # jvp's aux holds tensors only

    img, dot, n = torch.func.jvp(fn, (leaves,), (tangents,), has_aux=True)
    return {"image": img.numpy(), "tangent": dot.numpy(), "count": n.numpy()}


def jacfwd_params(scene) -> torch.Tensor:
    """The Jacobian cases' parameters [4]: the environment's ground colour
    and a scale on the triangles' emission (1: the scene as it is)."""
    from raytracingc_tpu_torch.scene.types import scene_leaves

    return torch.cat([scene_leaves(scene)[".env.ground"], torch.ones(1)])


def jacfwd_scene(scene, p):
    """``scene`` with the parameters ``p`` of :func:`jacfwd_params`."""
    from raytracingc_tpu_torch.scene.types import scene_leaves, with_leaves

    emission = scene_leaves(scene)[".triangles.emission"]
    return with_leaves(scene, {".env.ground": p[:3],
                               ".triangles.emission": emission * p[3]})


def case_jacfwd(data, size, strategy):
    """torch.func.jacfwd of a sharded render (production mode) by
    :func:`jacfwd_params`: the image's Jacobian [H, W, 3, 4]."""
    from raytracingc_tpu_torch.parallel import render_sharded

    w, h, spp, b, seed = JVP
    scene = load_scene(data, "demo")
    jac = torch.func.jacfwd(lambda p: render_sharded(
        jacfwd_scene(scene, p), _camera(data), w, h, spp=spp, max_bounce=b,
        seed=seed, strategy=strategy, mesh=_mesh(size // 2, 2))[0])
    return {"jacobian": jac(jacfwd_params(scene)).numpy()}


def case_merge(data, size, scene, knobs=None):
    """The merged winners of a block-sharded search of ``scene`` for the
    rays ``soup_rays/o``, ``soup_rays/d``."""
    from raytracingc_tpu_torch.ops.intersect import nearest_hit
    from raytracingc_tpu_torch.parallel.sharded import shard_scene

    mesh = _mesh(size, 1)
    local = shard_scene(load_scene(data, scene), mesh.get_local_rank("px"), size,
                        mesh.get_group("px"), torch.device("cpu"))
    o, d = (torch.from_numpy(data[f"soup_rays/{k}"]) for k in ("o", "d"))
    with _knobs(**(knobs or {})):
        ref = nearest_hit(o, d, local)
    return {"hit": ref.hit.numpy(), "is_tri": ref.is_tri.numpy(),
            "idx": ref.idx.numpy()}


def case_train(data, size, mesh_shape):
    """One make_train_step step (SGD) of every leaf of ``train`` against
    ``train/target``: the loss, the gradients the update used, the
    updated leaves."""
    from raytracingc_tpu_torch.parallel import make_train_step
    from raytracingc_tpu_torch.scene.types import scene_leaves

    w, h, spp, b, seed = TRAIN
    scene = load_scene(data, "train")
    o, d = primary_rays(_camera(data), w, h)
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in scene_leaves(scene).items()}
    opt = torch.optim.SGD(list(params.values()), lr=TRAIN_LR)
    step = make_train_step(_mesh(*mesh_shape), opt,
                           spp=spp, max_bounce=b, seed=seed)
    _, loss = step(scene, params, o, d, torch.arange(w * h),
                   torch.from_numpy(data["train/target"]))
    out = {"loss": np.array(loss)}
    for k, t in params.items():
        out[f"grad{k}"] = t.grad.numpy()
        out[f"leaf{k}"] = t.detach().numpy()
    return out


def case_progressive(data, size):
    from raytracingc_tpu_torch.render.progressive import render_progressive

    w, h, spp, b, seed = PROGRESSIVE
    return _image(lambda: render_progressive(
        load_scene(data, "demo"), _camera(data), w, h, spp, b,
        batch_spp=PROGRESSIVE_BATCH, seed=seed, shard_strategy="pixels"))


def case_progressive_bad_batch(data, size):
    """Samples sharding over 2 ranks with batches of 2, 2 and 1: refused
    before the first batch (1 when it raised, with no checkpoint written)."""
    from raytracingc_tpu_torch.render.progressive import render_progressive

    w, h, _, b, seed = PROGRESSIVE
    try:
        render_progressive(load_scene(data, "demo"), _camera(data), w, h, 5, b,
                           batch_spp=2, seed=seed, shard_strategy="samples")
    except ValueError as e:
        return {"raised": np.array("offending batch sizes [1]" in str(e))}
    return {"raised": np.array(False)}


def case_fit(data, size):
    """fit_scene(mesh=) on the albedo, SGD, FIT_STEPS steps."""
    from raytracingc_tpu_torch.diff import fit_scene

    w, h, spp, b, seed = TRAIN
    fitted, losses = fit_scene(
        load_scene(data, "train"), torch.from_numpy(data["train/target"]).reshape(
            h, w, 3), _camera(data), steps=FIT_STEPS, spp=spp, max_bounce=b,
        seed=seed, trainable=["albedo"],
        optimizer=lambda ps: torch.optim.SGD(ps, lr=TRAIN_LR),
        mesh=_mesh(size, 1))
    return {"losses": np.array(losses),
            "albedo": fitted.triangles.albedo.numpy()}


def case_dryrun(data, size):
    from raytracingc_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(size, "cpu")
    return {k: np.array(v) for k, v in out.items()}


def _blocks(size):
    """The block-sharded cases on ``size`` px ranks."""
    run = dict(run=BLOCKS, mesh_shape=(size, 1), scene_sharding="blocks")
    return {
        "blocks_accel": lambda data, n: case_render(data, n, "box_blocks", **run),
        "blocks_trivial": lambda data, n: case_render(data, n, "box_blocks_noaccel",
                                                       **run),
        "blocks_range": lambda data, n: case_render(data, n, "box_blocks", **run,
                                                     knobs={"RTC_CULL": "range"}),
        "merge_accel": lambda data, n: case_merge(data, n, "soup"),
        "merge_trivial": lambda data, n: case_merge(data, n, "soup_noaccel"),
        "merge_range": lambda data, n: case_merge(data, n, "soup",
                                                  knobs={"RTC_CULL": "range"}),
    }


CASES = {
    2: {
        "px": lambda data, n: case_render(data, n, "demo", PX),
        "px_box": lambda data, n: case_render(data, n, "box", PX),
        "samples": lambda data, n: case_render(data, n, "demo", SAMPLES,
                                               strategy="samples"),
        "train_1x2": lambda data, n: case_train(data, n, (1, 2)),
        "jvp_samples": lambda data, n: case_jvp(data, n, "samples"),
        "jacfwd_samples": lambda data, n: case_jacfwd(data, n, "samples"),
        "progressive": case_progressive,
        "progressive_bad_batch": case_progressive_bad_batch,
        "fit": case_fit,
        **_blocks(2),
    },
    4: {
        "px": lambda data, n: case_render(data, n, "demo", PX),
        "px_uneven": lambda data, n: case_render(data, n, "demo", PX_UNEVEN),
        "both": lambda data, n: case_render(data, n, "demo", SAMPLES,
                                            strategy="both"),
        "train_2x2": lambda data, n: case_train(data, n, (2, 2)),
        "jvp_both": lambda data, n: case_jvp(data, n, "both"),
        "jacfwd_both": lambda data, n: case_jacfwd(data, n, "both"),
        "blocks_both": lambda data, n: case_render(
            data, n, "box_blocks", BLOCKS, mesh_shape=(2, 2),
            scene_sharding="blocks"),
        **_blocks(4),
        "dryrun": case_dryrun,
    },
}


def main(argv) -> int:
    rank, size, port, out = argv
    rank, size = int(rank), int(size)
    torch.set_num_threads(1)
    from raytracingc_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", size, rank, "gloo")
    data = np.load(os.path.join(out, "inputs.npz"))
    results = {}
    for name, case in CASES[size].items():
        results.update({f"{name}/{k}": v for k, v in case(data, size).items()})
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    print(f"WORKER_PASS rank{rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
