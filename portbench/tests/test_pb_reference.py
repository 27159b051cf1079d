"""The plain reference against the port's CPU path at a tiny size, the
control in lower precision, and a run of every cell with its timed path
broken underneath: each fault the cell can have makes ``correct`` false."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny
from portbench import calibrate, run
from portbench.lib import check, spec, traffic

CPU = torch.device("cpu")
SEED = 2**31 + 977
FRAME_CELLS = ["cornell.frame1080", "cornell.preview128"]


def _run(name, seconds=0.0):
    result, _ = run.run_cell(tiny(spec.load_cell(name)), SEED, seconds, False, CPU)
    return result


@pytest.mark.parametrize("name", FRAME_CELLS + ["cornell.train256"])
def test_the_port_on_the_cpu_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and "breakdown" not in result
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", FRAME_CELLS)
def test_the_port_equals_the_reference_bit_for_bit(name):
    cell = tiny(spec.load_cell(name))
    d = traffic.Frames(cell.config, cell.traffic, SEED, CPU, False, keep=cell.check["frames"])
    rec = d.window(0.0)
    numbers, _ = check.check_frames(d, rec, dict(cell.check, pixel_share=1.0))
    assert numbers == {"mismatch_share": 0.0, "ray_count_gap": 0.0}


@pytest.mark.parametrize("name", FRAME_CELLS)
def test_the_bf16_control_fails_the_frames(name):
    cell = tiny(spec.load_cell(name))
    d = traffic.Frames(cell.config, cell.traffic, SEED, CPU, False, keep=cell.check["frames"])
    rec = d.window(0.0)
    numbers, _ = check.check_frames(d, rec, cell.check, control=torch.bfloat16)
    assert not check.verdict(numbers, cell.check["limits"])[0], numbers


def _fit_load():
    cell = tiny(spec.load_cell("cornell.train256"))
    d = traffic.Fit(cell.config, cell.traffic, SEED, CPU, False)
    d.step_s = 1.0
    return cell, d, d.window(0.0)


def test_set_up_leaves_out_the_reference_target_render(monkeypatch):
    import time

    from portbench.reference import tracer

    real, calls = tracer.radiance, []

    def slow(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:  # the fit's target, rendered in its set-up
            time.sleep(3.0)
        return real(*args, **kwargs)

    monkeypatch.setattr(tracer, "radiance", slow)
    t0 = time.perf_counter()
    result, _ = run.run_cell(tiny(spec.load_cell("cornell.train256")), SEED, 0.0, False,
                             CPU, t0=t0)
    assert result["correct"] and len(calls) > 1
    assert result["metrics"]["setup_s"]["value"] < 3.0 < time.perf_counter() - t0


def test_the_fit_follows_the_reference():
    cell, d, rec = _fit_load()
    numbers, steps = check.check_fit(d, rec, cell.check)
    assert steps == 3 and rec["steps"] >= 4
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-5
    assert numbers["update_gap"] < 1e-4


@pytest.mark.parametrize("control", ["bf16", "half", "altered"])
def test_the_fit_control_and_planted_faults_fail(control):
    cell, d, rec = _fit_load()
    ctl = {"bf16": {"dtype": torch.bfloat16}, "half": {"render": calibrate.half_rays},
           "altered": {"render": calibrate.first_row_doubled(cell.traffic["width"])}}[control]
    numbers, _ = check.check_fit(d, rec, cell.check, control=ctl)
    assert not check.verdict(numbers, cell.check["limits"])[0], numbers


# Faults planted in the program underneath a whole run.

def _stale_render(monkeypatch):
    """render() hands back the previous call's image: a step that returns
    its state unchanged."""
    from raytracingc_tpu_torch.render import renderer

    real, last = renderer.render, {}

    def render(*args, **kwargs):
        image, count = real(*args, **kwargs)
        out = last.get("image", image)
        last["image"] = image
        return out, count

    monkeypatch.setattr(renderer, "render", render)


def _patch_trace(monkeypatch, module, fault):
    real = module.trace_accumulate

    def trace_accumulate(origins, dirs, scene, ray_ids, *args, active=None, **kwargs):
        n = origins.shape[0]
        act = torch.ones(n, dtype=torch.bool) if active is None else active.clone()
        if fault == "half":  # half of the live lanes left out of the trace
            live = torch.nonzero(act).squeeze(1)
            act[live[live.numel() // 2:]] = False
        rad, count = real(origins, dirs, scene, ray_ids, *args, active=act, **kwargs)
        if fault == "altered":  # the call's answer (a chunk's radiance) altered
            rad = rad * 1.01
        return rad, count

    monkeypatch.setattr(module, "trace_accumulate", trace_accumulate)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", FRAME_CELLS)
def test_a_broken_render_is_not_correct(monkeypatch, name, fault):
    from raytracingc_tpu_torch.render import renderer

    if fault == "unchanged":
        _stale_render(monkeypatch)
    else:
        _patch_trace(monkeypatch, renderer, fault)
    result = _run(name)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_fit_is_not_correct(monkeypatch, fault):
    from raytracingc_tpu_torch.diff import optimize
    from raytracingc_tpu_torch.parallel import sharded

    if fault == "unchanged":  # every step leaves the parameters as they were
        monkeypatch.setattr(optimize, "_adam", lambda params, lr: torch.optim.Adam(params, lr=0.0))
    else:
        _patch_trace(monkeypatch, sharded, fault)
    result = _run("cornell.train256")
    assert not result["correct"], result["checks"]


def test_the_checked_frames_are_drawn_from_the_whole_window(monkeypatch):
    cell = tiny(spec.load_cell("cornell.preview128"))
    d = traffic.Frames(cell.config, cell.traffic, SEED, CPU, False, keep=4)
    monkeypatch.setattr(d, "_frame", lambda f: (torch.full((2, 2, 3), float(f)), 7))
    rec = d.window(0.02)
    n = rec["attempted"]
    assert n > 8 and len(d.kept) == 4 and max(d.kept) >= 4
    assert all(float(img[0, 0, 0]) == f for f, img in d.kept.items())
    assert sum(fr["rays"] for fr in rec["frames"]) == 7 * n
