"""The one traffic generator: a traffic file's ``kind`` picks its load.

Each load sets up the configuration's deployment into the program
(``raytracingc_tpu_torch``) through its public entry points with their
defaults, warms up the shapes its traffic uses, runs the measured window,
and keeps what the window produced for the correctness check.

* ``frames``: one client rendering frames back to back with
  ``render.renderer.render`` (a closed loop). Frame ``f`` renders
  ``spp`` samples from ``sample_offset = spp * f``; the camera is the
  configuration's or, where the mix has an ``orbit``, pose
  ``order[f % poses]`` of an orbit of the look-at point, the order drawn
  from the seed, so every seed renders the same poses. The window ends at
  the first frame boundary after ``seconds``; ``keep`` frames drawn from
  the seed over the whole window stay for the check.
* ``fit``: inverse rendering with ``diff.optimize.fit_scene``: the target
  is the reference's render of the configuration's scene, the start a
  perturbation of its albedo and vertices drawn from the mix's own
  ``perturb.seed`` (every run fits the same problem, so the run's seed,
  which draws the paths, does not change the work); the window is one
  ``fit_scene`` call of as many steps as the warm-up's step time fits into
  ``seconds``.

Both sides read the configuration's raw scene file (``reference/scene.py``'s
parser for the reference, the program's ``triangles.txt`` loader for the
program); a fit's start is numpy arrays that both take.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.lib.spec import ROOT
from portbench.lib.trace import Capture
from portbench.reference import scene as ref_scene


def sync(device):
    """Wait for the device (a no-op on the CPU, where tests drive a run)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seed_rng(seed: int, salt: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


def program_scene(config: dict, device, arrays=None):
    """The configuration's scene as the program's CLI loads it: the
    ``triangles.txt`` loader, with the default mode's sphere list where
    the configuration has spheres and none where it has none (the only
    two the loader offers); ``arrays`` (perturbed triangles) take the
    file's triangles' place, with the accel rebuilt for them."""
    import dataclasses

    from raytracingc_tpu_torch.scene.builder import (
        scene_from_triangles_txt, triangles_from_arrays)
    from raytracingc_tpu_torch.scene.types import EnvParams

    env = config["env"]
    scene = scene_from_triangles_txt(
        f"{ROOT}/{config['scene']}",
        env=EnvParams.from_values(env["sun_direction"], env["sky_horizon"],
                                  env["sky_zenith"], env["ground"],
                                  env["sun_focus"], env["sun_intensity"]),
        include_default_spheres=bool(config["spheres"]))
    if arrays is not None:
        tris, n_live = triangles_from_arrays(*arrays)
        scene = dataclasses.replace(scene, triangles=tris, n_triangles=n_live,
                                    accel=None).with_accel()
    return scene.to(device)


def camera_fov(camera: dict, width: int, height: int) -> float:
    """The program's ``fov`` (the view direction's length where the image's
    half height is 1) of a camera of ``focal_length`` on a square ``film``
    whose side fills the image's longer side."""
    return camera["focal_length"] / (0.5 * camera["film"] * height / max(width, height))


def orbit_poses(camera: dict, orbit: dict) -> list:
    """``poses`` camera origins on a circle about the look-at point's
    vertical axis, through the configuration's origin, at azimuths evenly
    spread over ``[-degrees, +degrees]`` from it."""
    o, t = np.asarray(camera["origin"], np.float64), np.asarray(camera["look_at"], np.float64)
    rel = o - t
    out = []
    for k in range(orbit["poses"]):
        a = math.radians(orbit["degrees"] * (2 * k / max(orbit["poses"] - 1, 1) - 1))
        x = rel[0] * math.cos(a) - rel[2] * math.sin(a)
        z = rel[0] * math.sin(a) + rel[2] * math.cos(a)
        out.append([float(t[0] + x), float(o[1]), float(t[2] + z)])
    return out


class Frames:
    """Closed-loop frames through ``render``."""

    def __init__(self, config, traffic, seed, device, trace: bool, keep: int = 1):
        from raytracingc_tpu_torch.camera import Camera
        from raytracingc_tpu_torch.render.renderer import render

        self._render, self._camera = render, Camera
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.trace, self.keep = trace, keep
        cam = config["camera"]
        orbit = traffic.get("orbit")
        origins = orbit_poses(cam, orbit) if orbit else [cam["origin"]]
        order = seed_rng(seed, 1).permutation(len(origins))
        self.poses = [origins[i] for i in order]
        self.scene = program_scene(config, device)

    def pose(self, f: int):
        cam, t = self.config["camera"], self.traffic
        return (self.poses[f % len(self.poses)], cam["look_at"],
                camera_fov(cam, t["width"], t["height"]))

    def _frame(self, f: int):
        t = self.traffic
        origin, look_at, fov = self.pose(f)
        camera = self._camera.look_at(origin=origin, target=look_at, fov=fov,
                                      device=self.device)
        return self._render(self.scene, camera, t["width"], t["height"],
                            spp=t["spp"], max_bounce=t["max_bounce"], seed=self.seed,
                            sample_offset=t["spp"] * f)

    def warm(self):
        """One frame at the window's shapes (a sample offset the window
        does not reach)."""
        self._frame(1 << 20)
        sync(self.device)

    def window(self, seconds: float) -> dict:
        trace = self.traffic["trace"]
        first, last = trace["skip"], trace["skip"] + trace["frames"]
        capture = Capture() if self.trace else None
        # A seeded reservoir keeps `keep` frames drawn evenly from the whole
        # window for the check, and no others.
        keep, gen = self.keep, seed_rng(self.seed, 3)
        self.kept, frames = {}, []
        start = time.perf_counter()
        while True:
            f = len(frames)
            if capture is not None and f == first:
                capture.start()
            t0 = time.perf_counter()
            image, count = self._frame(f)
            sync(self.device)
            t1 = time.perf_counter()
            if capture is not None and f + 1 == last:
                capture.stop({"rays": sum(fr["rays"] for fr in frames[first:]) + count,
                              "frames": last - first})
            if f < keep:
                self.kept[f] = image
            else:
                j = int(gen.integers(0, f + 1))
                if j < keep:
                    del self.kept[sorted(self.kept)[j]]
                    self.kept[f] = image
            frames.append({"wall_s": t1 - t0, "rays": int(count)})
            if t1 - start >= seconds and (capture is None or f + 1 >= last):
                break
        return {"window_s": t1 - start, "frames": frames, "attempted": len(frames),
                "span": capture.span if capture else None}


class Fit:
    """``fit_scene`` steps from a seeded start towards a rendered target."""

    def __init__(self, config, traffic, seed, device, trace: bool, keep: int = 0):
        """``keep`` is for frames; a fit keeps its first steps."""
        from raytracingc_tpu_torch.camera import Camera
        from raytracingc_tpu_torch.diff.optimize import fit_scene

        from portbench.reference import tracer

        self._fit, self.trace = fit_scene, trace
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = traffic
        cam = config["camera"]
        self.fov = camera_fov(cam, t["width"], t["height"])
        self.truth = ref_scene.scene_arrays(config, ROOT)
        self.start_arrays = perturb(self.truth, t["perturb"],
                                    np.random.default_rng(t["perturb"]["seed"]))
        # The target: the reference's render of the true scene (before the
        # program's set-up, whose peak memory is read from here on). Its
        # seconds are the reference's, not the set-up's.
        t0 = time.perf_counter()
        origins, dirs = ref_scene.primary_rays(cam["origin"], cam["look_at"], self.fov,
                                               t["width"], t["height"], device)
        ids = torch.arange(origins.shape[0], device=device)
        truth = ref_scene.build_scene(config, ROOT, device, self.truth)
        with torch.no_grad():
            target, _ = tracer.radiance(origins, dirs, ids, truth, seed, t["spp"],
                                        t["max_bounce"])
        self.target = target.reshape(t["height"], t["width"], 3)
        sync(device)
        self.reference_s = time.perf_counter() - t0
        del truth, origins, dirs, ids
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.camera = Camera.look_at(origin=cam["origin"], target=cam["look_at"],
                                     fov=self.fov, device=device)
        self.scene = program_scene(config, device, self.start_arrays)

    def _call(self, steps: int):
        t = self.traffic
        return self._fit(self.scene, self.target, self.camera, steps=steps,
                         learning_rate=t["learning_rate"], spp=t["spp"],
                         max_bounce=t["max_bounce"], seed=self.seed,
                         trainable=t["trainable"])

    def warm(self):
        """A first call, then a timed one: its step time sizes the window."""
        first, timed = self.traffic["warm_steps"]
        self._call(first)
        sync(self.device)
        t0 = time.perf_counter()
        self._call(timed)
        sync(self.device)
        self.step_s = (time.perf_counter() - t0) / timed

    def window(self, seconds: float) -> dict:
        """One ``fit_scene`` call. Optimizer hooks read, without touching the
        step: the trained tensors' names (by their values before step 1),
        the first gradient (Adam's first moment after step 1), the fields
        after ``check_steps`` steps, and the traced steps' span."""
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        trace, check_steps = self.traffic["trace"], self.traffic["check_steps"]
        steps = max(int(round(seconds / self.step_s)),
                    trace["skip"] + trace["steps"] + 1, check_steps + 1)
        capture = Capture() if self.trace else None
        start = {k: torch.as_tensor(v) for k, v in self.start_fields().items()}
        seen = {"step": 0}

        def pre(opt, args, kwargs):
            if "names" not in seen:
                seen["names"] = _match(opt, start)

        def post(opt, args, kwargs):
            seen["step"] += 1
            n = seen["step"]
            if n == 1:
                beta1 = opt.param_groups[0]["betas"][0]
                seen["grads"] = {k: opt.state[p]["exp_avg"][:rows].detach().cpu()
                                 / (1 - beta1) for k, p, rows in _named(opt, seen["names"])}
            if n == check_steps:
                seen["params"] = {k: p[:rows].detach().cpu().clone()
                                  for k, p, rows in _named(opt, seen["names"])}
            if capture is not None and n == trace["skip"]:
                capture.start()
            if capture is not None and n == trace["skip"] + trace["steps"]:
                capture.stop({"steps": trace["steps"]})

        handles = [register_optimizer_step_pre_hook(pre),
                   register_optimizer_step_post_hook(post)]
        try:
            sync(self.device)
            t0 = time.perf_counter()
            _, losses = self._call(steps)
            sync(self.device)
            wall = time.perf_counter() - t0
        finally:
            for h in handles:
                h.remove()
        self.losses, self.grads, self.params = losses, seen["grads"], seen["params"]
        return {"window_s": wall, "steps": steps, "attempted": steps,
                "span": capture.span if capture else None}

    def start_fields(self) -> dict:
        """The start scene's trained fields, by the reference's names."""
        verts, normals, albedo, _, _ = self.start_arrays
        fields = {"a": verts[:, 0], "b": verts[:, 1], "c": verts[:, 2],
                  "normal": normals, "albedo": albedo}
        return {k: fields[k] for k in trained_fields(self.traffic["trainable"])}


def trained_fields(trainable) -> list:
    """The scene fields ``fit_scene(trainable=...)`` trains: those whose
    leaf name ``.triangles.<field>`` holds one of the substrings."""
    return [k for k in ("a", "b", "c", "normal", "albedo", "emission", "smoothness")
            if any(s in f".triangles.{k}" for s in trainable)]


def _match(opt, leaves: dict) -> dict:
    """``{id(param): (field, rows)}``: each optimised tensor named by the
    start field whose values its first ``rows`` rows hold before the first
    step (the program pads its triangle table past the scene's rows)."""
    out = {}
    for group in opt.param_groups:
        for p in group["params"]:
            host = p.detach().cpu()
            names = [k for k, v in leaves.items()
                     if v.shape[1:] == host.shape[1:] and v.shape[0] <= host.shape[0]
                     and torch.equal(v, host[:v.shape[0]])]
            if len(names) != 1:
                raise RuntimeError(f"cannot name an optimised tensor of shape "
                                   f"{tuple(host.shape)}: matches {names}")
            out[id(p)] = names[0], leaves[names[0]].shape[0]
    return out


def _named(opt, names: dict):
    """``(field, tensor, rows of the scene)`` of each optimised tensor."""
    for group in opt.param_groups:
        for p in group["params"]:
            yield (*names[id(p)][:1], p, names[id(p)][1])


def perturb(arrays, spec: dict, gen: np.random.Generator):
    """The start of a fit: each triangle's albedo moved by up to
    ``spec["albedo"]`` (kept in [0, 1]), and every vertex by a smooth
    seeded field of amplitude ``spec["vertex"]`` times the scene's extent
    (the longest side of its bounding box) and a wavelength of about that
    extent (a vertex that triangles share moves once, so shared edges stay
    shared)."""
    verts, normals, albedo, emission, smoothness = arrays
    albedo = np.clip(albedo + gen.uniform(-spec["albedo"], spec["albedo"],
                                          albedo.shape), 0.0, 1.0).astype(np.float32)
    extent = float(np.ptp(verts.reshape(-1, 3), axis=0).max())
    w = gen.normal(0.0, 2 * np.pi / extent, (3, 3))
    phase = gen.uniform(0.0, 2 * np.pi, 3)
    field = spec["vertex"] * extent * np.sin(verts.astype(np.float64) @ w + phase)
    verts = (verts + field).astype(np.float32)
    return verts, normals, albedo, emission, smoothness


KINDS = {"frames": Frames, "fit": Fit}
