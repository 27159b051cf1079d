"""Whether what the window produced is correct: the comparison with the
plain reference (``portbench/reference/``), once the window has closed.

Each cell's ``checks/<cell>.json`` says what is sampled and the limit of
every number compared; a run is correct when no number exceeds its limit.

* ``frames``: ``frames`` frames drawn from the seed evenly over the whole
  window (the frames generator's reservoir), and of each a share
  ``pixel_share`` of its pixels drawn from the seed (all of them at 1).
  The reference traces those pixels with the frame's camera, seed and
  sample offset. ``mismatch_share``: the share of the compared
  pixels whose radiance differs from the reference's, in any channel, by
  more than ``PIXEL_RTOL`` of the reference's value plus ``PIXEL_ATOL``
  (a path whose hit flips on rounding differs by far more than that, and
  is counted). ``ray_count_gap``: the largest relative gap between a
  frame's traced-ray count and the reference's (whole frames only).
* ``fit``: the reference follows the window's first ``check_steps`` steps
  from the same start, target and seed with ``torch.optim.Adam``.
  ``loss_gap``: the largest relative gap of a step's loss. ``grad_gap``:
  over the trained fields, the largest gap between the norms of the first
  step's gradient (the program's read from Adam's first moment after one
  step), as a share of the reference's norm of that field or of the
  median field's, whichever is larger. ``update_gap``: the same for the
  norm of each field's change over the ``check_steps`` steps. A field
  whose reference gradient is under a thousandth of the median field's
  moves under Adam by round-off alone and is left out of both.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib.traffic import seed_rng
from portbench.lib.spec import ROOT
from portbench.reference import scene as ref_scene
from portbench.reference import tracer

PIXEL_RTOL = 1e-4
PIXEL_ATOL = 1e-6


def _plain_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def frame_pixels(n_pix: int, share: float, gen) -> np.ndarray:
    """The compared pixel ids of a frame, sorted."""
    if share >= 1.0:
        return np.arange(n_pix)
    return np.sort(gen.choice(n_pix, size=max(1, int(n_pix * share)), replace=False))


def check_frames(load, record: dict, check: dict, control=None):
    """``({number: value}, frames checked)`` for a ``frames`` window.
    ``control`` (a dtype) puts the reference computed in that precision in
    the program's place."""
    _plain_precision()
    t, cfg, dev = load.traffic, load.config, load.device
    gen = seed_rng(load.seed, 4)
    picks = sorted(load.kept)
    sc = ref_scene.build_scene(cfg, ROOT, dev)
    n_pix = t["width"] * t["height"]
    bad = total = 0
    count_gap = 0.0
    for f in picks:
        pix = torch.as_tensor(frame_pixels(n_pix, check["pixel_share"], gen), device=dev)
        origin, look_at, fov = load.pose(f)
        o, d = ref_scene.primary_rays(origin, look_at, fov, t["width"], t["height"], dev)
        with torch.no_grad():
            ref, count = tracer.radiance(o[pix], d[pix], pix, sc, load.seed, t["spp"],
                                         t["max_bounce"], sample_offset=t["spp"] * f)
        rays = record["frames"][f]["rays"]
        if control is None:
            got = load.kept[f].reshape(-1, 3)[pix.to(load.kept[f].device)].to(dev)
        else:
            with torch.no_grad():
                got, rays = tracer.radiance(o[pix], d[pix], pix, sc.cast(control), load.seed,
                                            t["spp"], t["max_bounce"],
                                            sample_offset=t["spp"] * f)
            got = got.float()
        gap = (got - ref).abs() > PIXEL_RTOL * ref.abs() + PIXEL_ATOL
        bad += int(gap.any(dim=1).sum())
        total += pix.numel()
        if pix.numel() == n_pix:
            count_gap = max(count_gap, abs(rays - count) / count)
    out = {"mismatch_share": bad / total}
    if check["pixel_share"] >= 1.0:
        out["ray_count_gap"] = count_gap
    return out, len(picks)


def norm_gaps(prog: dict, ref: dict, fields) -> float:
    """The worst field's ``|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in fields}
    median = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
               / max(norms[k], median) for k in fields)


def check_fit(load, record: dict, check: dict, control=None):
    """``({number: value}, steps checked)`` for a ``fit`` window.
    ``control``, ``{"dtype": ..., "render": ...}``, puts the reference in
    the program's place, computed in that precision or with that
    ``radiance``."""
    _plain_precision()
    t, cfg, dev = load.traffic, load.config, load.device
    cam = cfg["camera"]
    steps = t["check_steps"]
    sc = ref_scene.build_scene(cfg, ROOT, dev, load.start_arrays)
    o, d = ref_scene.primary_rays(cam["origin"], cam["look_at"], load.fov,
                                  t["width"], t["height"], dev)
    ids = torch.arange(o.shape[0], device=dev)
    fields = list(load.grads)
    losses, grads, params = tracer.fit_steps(
        sc, fields, o, d, ids, load.target, load.seed, t["spp"], t["max_bounce"],
        t["learning_rate"], steps)
    start = {k: getattr(sc, k).detach() for k in fields}
    p_losses, p_grads, p_params = load.losses, load.grads, load.params
    if control is not None:
        p_losses, p_grads, p_params = tracer.fit_steps(
            sc.cast(control.get("dtype", torch.float32)), fields, o, d, ids,
            load.target, load.seed, t["spp"], t["max_bounce"], t["learning_rate"],
            steps, render=control.get("render"))
        p_grads = {k: g.float().cpu() for k, g in p_grads.items()}
        p_params = {k: v.float().cpu() for k, v in p_params.items()}
    grads = {k: g.float().cpu() for k, g in grads.items()}
    g_norm = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    median = float(np.median(list(g_norm.values())))
    moving = [k for k in fields if g_norm[k] >= 1e-3 * median]
    change_ref = {k: (params[k] - start[k]).float().cpu() for k in moving}
    start_prog = {k: torch.as_tensor(v) for k, v in load.start_fields().items()}
    change_prog = {k: p_params[k] - start_prog[k] for k in moving}
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(p_losses[:steps], losses)),
        "grad_gap": norm_gaps(p_grads, grads, moving),
        "update_gap": norm_gaps(change_prog, change_ref, moving),
    }, steps


CHECKS = {"frames": check_frames, "fit": check_fit}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit"}})``; a number without a
    limit, or one that is not finite, fails."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        out[k] = {"value": v, "limit": lim}
        if lim is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, out
