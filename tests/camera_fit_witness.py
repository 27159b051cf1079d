"""The camera example's fit in both packages, step by step (ROADMAP Queue 3, C3).

``examples/inverse_camera.py`` (JAX) and
``raytracingc_tpu_torch.examples.inverse_camera`` (the port) fit the same
perturbed pose on the same demo scene and target, on the CPU. This module
tells where and why their loss sequences part:

* :func:`free`: both packages' ``fit_camera`` with the examples' arguments,
  each on its own trajectory: the losses and the cameras after ``steps``.
* :func:`forced`: JAX's fit (its ``fit_camera`` loop: ``optax.adam``, one
  ``value_and_grad`` a step), with the port's loss, image and gradient
  taken at each step's camera of JAX's trajectory: the per-step function
  held alone.
* :func:`flip`: after ``steps`` steps of both free fits, the pixel whose
  radiance differs most between the packages, its value in each, the port's
  value at JAX's camera, and each package's primary hit there.
* :func:`jacobians`: at one camera, both packages' per-pixel derivatives of
  the image by the six pose parameters (``jax.jacfwd`` and
  ``torch.func.jacfwd``), the pixel where they differ most, and how much
  JAX's own derivative there moves when one parameter moves by one float32
  ulp.

    python tests/camera_fit_witness.py [--steps 40]

prints one line per step (both losses, the free and the forced relative
gaps, the forced largest pixel difference and gradient difference), then
the witness at the first step whose free gap exceeds 1e-5 and at the first
that exceeds 1e-3, and the Jacobians at JAX's camera of step 0 and of the
step with the largest forced gradient difference.
``tests/test_torch_reference_checks.py`` holds the first steps.
"""

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from __graft_entry__ import _demo_scene  # noqa: E402
from raytracingc_tpu.camera import Camera as JCamera  # noqa: E402
from raytracingc_tpu.camera import look_at_basis as j_look_at_basis  # noqa: E402
from raytracingc_tpu.camera import primary_rays as j_primary_rays  # noqa: E402
from raytracingc_tpu.diff.optimize import fit_camera as j_fit_camera  # noqa: E402
from raytracingc_tpu.ops.intersect import nearest_hit as j_nearest_hit  # noqa: E402
from raytracingc_tpu.render.integrator import trace_accumulate as j_trace  # noqa: E402
from raytracingc_tpu_torch.camera import Camera, look_at_basis, primary_rays  # noqa: E402
from raytracingc_tpu_torch.diff import fit_camera  # noqa: E402
from raytracingc_tpu_torch.examples import inverse_camera as example  # noqa: E402
from raytracingc_tpu_torch.examples.demo import demo_scene  # noqa: E402
from raytracingc_tpu_torch.ops.intersect import nearest_hit  # noqa: E402
from raytracingc_tpu_torch.render.integrator import trace_accumulate  # noqa: E402

SIZE, SPP, MAX_BOUNCE, LR = 40, 2, 2, 1e-2  # the examples' defaults


def inputs():
    """Both packages' scene, target [H, W, 3] and perturbed camera, built as
    the two examples build them."""
    js = _demo_scene()
    jc_true = JCamera.look_at(example.TRUE_ORIGIN, example.TRUE_LOOK)
    o, d = j_primary_rays(jc_true, SIZE, SIZE)
    ids = jnp.arange(SIZE * SIZE, dtype=jnp.uint32)
    jt, _ = j_trace(o, d, js, ids, seed=0, spp=SPP, max_bounce=MAX_BOUNCE)
    pert = jc_true.ez + jnp.asarray([-0.03, 0.025, 0.035])
    pert = pert / jnp.linalg.norm(pert)
    origin0 = jc_true.origin + jnp.asarray([0.12, -0.08, 0.1])
    ex, ey, ez = j_look_at_basis(origin0, origin0 + pert)
    jc0 = jc_true.replace(origin=origin0, ex=ex, ey=ey, ez=ez)

    ts = demo_scene("cpu")
    tc_true = Camera.look_at(example.TRUE_ORIGIN, example.TRUE_LOOK)
    o, d = primary_rays(tc_true, SIZE, SIZE)
    tt, _ = trace_accumulate(o, d, ts, torch.arange(SIZE * SIZE), seed=0, spp=SPP,
                             max_bounce=MAX_BOUNCE)
    return ((js, jt.reshape(SIZE, SIZE, 3), jc0),
            (ts, tt.reshape(SIZE, SIZE, 3), example.perturbed(tc_true)))


def free(steps: int, ins=None):
    """``(JAX's losses, the port's losses, JAX's camera, the port's camera)``
    after ``steps`` steps of each package's own ``fit_camera``."""
    (js, jt, jc0), (ts, tt, tc0) = ins or inputs()
    kw = dict(steps=steps, learning_rate=LR, spp=SPP, max_bounce=MAX_BOUNCE, seed=0)
    jc, jl = j_fit_camera(js, jt, jc0, **kw)
    tc, tl = fit_camera(ts, tt, tc0, **kw)
    return np.array(jl), np.array(tl), jc, tc


def _port_camera(jc) -> Camera:
    f = lambda x: torch.from_numpy(np.array(x))
    return Camera(origin=f(jc.origin), ex=f(jc.ex), ey=f(jc.ey), ez=f(jc.ez),
                  fov=float(jc.fov))


def _port_image(ts, cam: Camera) -> np.ndarray:
    o, d = primary_rays(cam, SIZE, SIZE)
    with torch.no_grad():
        r, _ = trace_accumulate(o, d, ts, torch.arange(SIZE * SIZE), seed=0,
                                spp=SPP, max_bounce=MAX_BOUNCE, early_exit=False)
    return r.numpy()


def _jax_image(js, jc) -> np.ndarray:
    o, d = j_primary_rays(jc, SIZE, SIZE)
    r, _ = j_trace(o, d, js, jnp.arange(SIZE * SIZE, dtype=jnp.uint32), seed=0,
                   spp=SPP, max_bounce=MAX_BOUNCE)
    return np.asarray(r)


def _port_pose_image(ts, fov):
    """The port's image [R, 3] as a function of the pose ``v`` [6] (origin,
    then view direction), through the port's ``fit_camera``
    parameterisation."""
    def image(v):
        x, y, z = v[3:].unbind(-1)
        dn = v[3:] / torch.sqrt(x * x + y * y + z * z)
        ex, ey, ez = look_at_basis(v[:3], v[:3] + dn)
        o, d = primary_rays(Camera(origin=v[:3], ex=ex, ey=ey, ez=ez,
                                   fov=torch.tensor(float(fov))), SIZE, SIZE)
        r, _ = trace_accumulate(o, d, ts, torch.arange(SIZE * SIZE), seed=0, spp=SPP,
                                max_bounce=MAX_BOUNCE)
        return r
    return image


def _jax_pose_image(js, jc0):
    """JAX's image [R, 3] as a function of the pose ``v`` [6], through JAX's
    ``fit_camera`` parameterisation."""
    ids = jnp.arange(SIZE * SIZE, dtype=jnp.uint32)

    def image(v):
        dn = v[3:] / jnp.linalg.norm(v[3:])
        ex, ey, ez = j_look_at_basis(v[:3], v[:3] + dn)
        o, d = j_primary_rays(jc0.replace(origin=v[:3], ex=ex, ey=ey, ez=ez), SIZE, SIZE)
        r, _ = j_trace(o, d, js, ids, seed=0, spp=SPP, max_bounce=MAX_BOUNCE)
        return r
    return image


def _pose(params) -> np.ndarray:
    return np.concatenate([np.asarray(params["origin"]), np.asarray(params["dir"])])


def _port_loss_grad(ts, params, fov, target):
    """The port's image and the gradient of its loss at JAX's parameters."""
    v = torch.from_numpy(_pose(params)).requires_grad_(True)
    r = _port_pose_image(ts, fov)(v)
    ((r - torch.tensor(target)) ** 2).mean().backward()
    return r.detach().numpy(), v.grad.numpy()


def forced(steps: int, ins=None) -> list[dict]:
    """Per step of JAX's fit: ``jax`` and ``port``, the two losses at JAX's
    camera of that step, ``max_pixel``, the largest difference of the two
    images there, and ``grad``, the largest difference of the two gradients
    over JAX's largest gradient entry; ``pose``, JAX's camera parameters
    [6] of that step."""
    (js, jt, jc0), (ts, _, _) = ins or inputs()
    tgt = jt.reshape(-1, 3)
    ids = jnp.arange(SIZE * SIZE, dtype=jnp.uint32)

    def build(p):
        dn = p["dir"] / jnp.linalg.norm(p["dir"])
        ex, ey, ez = j_look_at_basis(p["origin"], p["origin"] + dn)
        return jc0.replace(origin=p["origin"], ex=ex, ey=ey, ez=ez)

    def loss_fn(p):
        o, d = j_primary_rays(build(p), SIZE, SIZE)
        r, _ = j_trace(o, d, js, ids, seed=0, spp=SPP, max_bounce=MAX_BOUNCE)
        return jnp.mean((r - tgt) ** 2), r

    step_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    opt = optax.adam(LR)
    params = {"origin": jc0.origin, "dir": jc0.ez}
    state = opt.init(params)
    target = np.asarray(tgt)
    rows = []
    for _ in range(steps):
        (loss, jr), grads = step_fn(params)
        tr, tg = _port_loss_grad(ts, params, jc0.fov, target)
        jg = _pose(grads)
        rows.append({"jax": float(loss), "port": float(((tr - target) ** 2).mean()),
                     "max_pixel": float(np.abs(tr - np.asarray(jr)).max()),
                     "grad": float(np.abs(tg - jg).max() / np.abs(jg).max()),
                     "pose": _pose(params)})
        updates, state = opt.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
    return rows


def flip(steps: int, ins=None) -> dict:
    """After ``steps`` steps of both free fits: ``camera`` (the largest
    difference of the two cameras' origin and view direction), ``pixel``
    (row, column) of the largest image difference, its radiance ``jax``,
    ``port`` and ``port_at_jax_camera``, and each package's primary hit
    there, ``(hit, is_tri, idx)``."""
    ins = ins or inputs()
    (js, _, _), (ts, _, _) = ins
    _, _, jc, tc = free(steps, ins)
    jr, tr = _jax_image(js, jc), _port_image(ts, tc)
    at_jax = _port_image(ts, _port_camera(jc))
    i = int(np.abs(tr - jr).max(axis=1).argmax())
    o, d = j_primary_rays(jc, SIZE, SIZE)
    jh = j_nearest_hit(o, d, js)
    o, d = primary_rays(tc, SIZE, SIZE)
    th = nearest_hit(o, d, ts)
    hit = lambda h: (bool(h.hit[i]), bool(h.is_tri[i]), int(h.idx[i]))
    camera = max(float(np.abs(np.asarray(getattr(jc, f)) - getattr(tc, f).numpy()).max())
                 for f in ("origin", "ez"))
    return {"camera": camera, "pixel": divmod(i, SIZE), "jax": jr[i].tolist(),
            "port": tr[i].tolist(), "port_at_jax_camera": at_jax[i].tolist(),
            "jax_hit": hit(jh), "port_hit": hit(th)}


def jacobians(pose, ins=None) -> dict:
    """At the camera parameters ``pose`` [6]: both packages' Jacobians of the
    image, [R, 3, 6]. ``pixel`` (row, column) is where they differ most;
    ``gap``, that difference over the pixel's largest JAX entry; ``others``,
    the largest difference at every other pixel over JAX's largest entry
    anywhere; ``jax_ulp``, the most JAX's own derivative at ``pixel`` moves
    (over the same entry) when one parameter moves up by one float32 ulp."""
    (js, _, jc0), (ts, _, _) = ins or inputs()
    jac = jax.jit(jax.jacfwd(_jax_pose_image(js, jc0)))
    jj = np.asarray(jac(jnp.asarray(pose)))
    image = _port_pose_image(ts, jc0.fov)
    jt = torch.func.jacfwd(image)(torch.from_numpy(np.array(pose))).numpy()
    diff = np.abs(jt - jj).max(axis=(1, 2))
    i = int(diff.argmax())
    own = float(np.abs(jj[i]).max())
    moved = []
    for e in range(6):
        up = np.array(pose)
        up[e] = np.nextafter(up[e], np.float32(np.inf))
        moved.append(float(np.abs(np.asarray(jac(jnp.asarray(up)))[i] - jj[i]).max()))
    return {"pixel": divmod(i, SIZE), "gap": float(diff[i]) / own,
            "others": float(np.delete(diff, i).max() / np.abs(jj).max()),
            "jax_ulp": max(moved) / own}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=40)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    ins = inputs()
    jl, tl, _, _ = free(args.steps, ins)
    rows = forced(args.steps, ins)
    gap = np.abs(tl - jl) / np.abs(jl)
    print("step jax_loss port_loss free_gap forced_gap forced_max_pixel forced_grad")
    for k, r in enumerate(rows):
        print(f"{k} {float(jl[k])!r} {float(tl[k])!r} {gap[k]:.3e} "
              f"{abs(r['port'] - r['jax']) / r['jax']:.3e} {r['max_pixel']:.3e} "
              f"{r['grad']:.3e}")
    for bar in (1e-5, 1e-3):
        over = np.nonzero(gap > bar)[0]
        if len(over):
            k = int(over[0])
            print(f"first free gap > {bar:g}: step {k} ({gap[k]:.3e}): {flip(k, ins)}")
    worst = max(range(len(rows)), key=lambda k: rows[k]["grad"])
    for k in sorted({0, worst}):
        print(f"Jacobians at JAX's camera of step {k}: {jacobians(rows[k]['pose'], ins)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
