"""The port's spans and counters (``raytracingc_tpu_torch/utils/profiling.py``).

Spans exist only while a ``torch.profiler`` runs (otherwise no
``RecordFunction`` is made), nest as the layers do, and sit in the
profiler's event stream; the counters of bounces, lanes and search pairs
equal what the integrator and the search do. CPU only, tiny renders of
``examples/box_scene.txt``.
"""

import collections
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.diff.optimize import fit_scene
from raytracingc_tpu_torch.ops import search_brute as brute_mod
from raytracingc_tpu_torch.render.integrator import render_debug
from raytracingc_tpu_torch.render.renderer import render, trace_rays
from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
from raytracingc_tpu_torch.utils import profiling
from raytracingc_tpu_torch.utils.profiling import (
    counters,
    start_trace,
    stop_trace,
    trace_annotation,
)

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
W = H = 16
CHUNK = 100  # 256 pixels padded to 300: the last chunk has 44 dead lanes

# Where each span may open: the innermost rtc. span around it.
PARENTS = {
    "rtc.render": {None},
    "rtc.chunk": {"rtc.render"},
    "rtc.primary": {"rtc.chunk", "rtc.train.forward"},
    "rtc.bounce": {"rtc.chunk", "rtc.train.forward"},
    "rtc.compact": {"rtc.chunk", "rtc.bounce", "rtc.train.forward"},
    # rtc.primary: the hit-front's bounce-0 radiance, with the primary resolve.
    "rtc.shade": {"rtc.chunk", "rtc.primary", "rtc.bounce", "rtc.train.forward"},
    "rtc.search": {"rtc.primary", "rtc.bounce"},
    "rtc.cull": {"rtc.search"},
    "rtc.resolve": {"rtc.primary", "rtc.bounce"},
    "rtc.train.step": {None},
    "rtc.train.forward": {"rtc.train.step"},
    "rtc.train.backward": {"rtc.train.step"},
    "rtc.train.update": {"rtc.train.step"},
    "rtc.train.refresh": {"rtc.train.step"},
}

MODES = {
    "production": {},
    "fast_forward": dict(early_exit=False),
    "sample_group": dict(sample_group=2),
    "sample_batch": dict(sample_batch=2),
    "oracle": dict(early_exit=False, compact=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return scene_from_triangles_txt(BOX_SCENE)


def _render(scene, **kw):
    return render(scene, Camera.look_at(), W, H, spp=2, max_bounce=4, seed=3,
                  pixel_chunk=CHUNK, **kw)


def _profiled(fn):
    """``(fn's result, counter deltas, rtc. spans)`` of ``fn()`` under a CPU
    profiler; a span is ``(name, start_ns, end_ns, thread)``."""
    before = counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = counters()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("rtc.")]
    return out, {k: after[k] - before[k] for k in after}, spans


def _parents(spans):
    """Each span with the innermost span of its thread that holds it."""
    out = []
    for s in spans:
        holders = [p for p in spans if p is not s and p[3] == s[3]
                   and p[1] <= s[1] and s[2] <= p[2]]
        inner = max(holders, key=lambda p: (p[1], -p[2]), default=None)
        out.append((s[0], inner[0] if inner else None))
    return out


def test_no_profiler_makes_no_record_function(scene, monkeypatch):
    assert trace_annotation("rtc.render") is trace_annotation("rtc.bounce", call=1)

    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction was made with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    before = counters()
    img, n = _render(scene)
    assert img.shape == (H, W, 3) and n > 0
    assert counters()["integrator.lanes"] - before["integrator.lanes"] == n


def test_spans_nest_as_the_layers(scene, monkeypatch):
    # The packet route: the culling prelude runs (box_scene has an accel).
    monkeypatch.setenv("RTC_KERNEL", "packet")
    _, _, spans = _profiled(lambda: _render(scene))
    names = collections.Counter(s[0] for s in spans)
    assert set(names) == {"rtc.render", "rtc.chunk", "rtc.primary", "rtc.bounce",
                          "rtc.compact", "rtc.shade", "rtc.search", "rtc.cull",
                          "rtc.resolve"}
    assert names["rtc.render"] == 1 and names["rtc.chunk"] == 3
    assert names["rtc.cull"] == names["rtc.search"] == names["rtc.resolve"]
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)


def test_trace_rays_is_one_render_span(scene):
    from raytracingc_tpu_torch.camera import primary_rays

    o, d = primary_rays(Camera.look_at(), W, H)
    ids = torch.arange(W * H)
    (_, n), _, spans = _profiled(lambda: trace_rays(scene, o, d, ids, 1, 2,
                                                    pixel_chunk=CHUNK))
    names = collections.Counter(s[0] for s in spans)
    assert names["rtc.render"] == 1 and names["rtc.chunk"] == 3 and n > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lanes_counter_equals_the_returned_count(scene, mode):
    (img, n), delta, _ = _profiled(lambda: _render(scene, **MODES[mode]))
    assert isinstance(n, int) and n > W * H
    assert delta["integrator.lanes"] == n


@pytest.mark.parametrize("mode", sorted(MODES) + ["debug"])
def test_bounces_counter_equals_bounce_and_primary_spans(scene, mode):
    if mode == "debug":
        run = lambda: render_debug(scene, Camera.look_at(), W, H, max_bounce=4)
    else:
        run = lambda: _render(scene, **MODES[mode])
    _, delta, spans = _profiled(run)
    names = collections.Counter(s[0] for s in spans)
    assert delta["integrator.bounces"] == names["rtc.bounce"] + names["rtc.primary"] > 0
    assert names["rtc.search"] == delta["integrator.bounces"]


def test_search_pairs_count_every_lane_handed_to_the_brute_search(scene):
    """Primary searches get whole chunks, dead padding included; the loop's
    searches get the live lanes, which the lanes counter counts."""
    spp = 2
    (_, n), delta, _ = _profiled(lambda: _render(scene))
    padded = -(-W * H // CHUNK) * CHUNK
    loop_lanes = n - W * H * spp  # the hit-front counts the primary once a sample
    assert delta["search.pairs"] == scene.n_triangles * (padded + loop_lanes)
    assert delta["integrator.bounces"] > 0

    o = torch.zeros((10, 3))
    d = torch.zeros((10, 3))
    d[:, 2] = 1.0
    alive = torch.arange(10) < 4
    before = counters()["search.pairs"]
    brute_mod.search_brute(o, d, scene.triangles, 7, alive)
    brute_mod.search_brute(o[:6], d[:6], scene.triangles, 5)
    assert counters()["search.pairs"] - before == 10 * 7 + 6 * 5


def test_fit_scene_spans_once_a_step(scene):
    target = torch.zeros((8, 8, 3))
    steps = 2
    _, _, spans = _profiled(lambda: fit_scene(
        scene, target, Camera.look_at(), steps=steps, spp=1, max_bounce=2,
        trainable=["triangles.albedo", "triangles.b"]))
    names = collections.Counter(s[0] for s in spans)
    for part in ("step", "forward", "backward", "update"):
        assert names[f"rtc.train.{part}"] == steps, part
    # The first step refreshes the accel before its loss and after its
    # update; later steps take the accel the last one returned.
    assert names["rtc.train.refresh"] == steps + 1
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)


def test_start_stop_trace_holds_the_spans(scene, tmp_path):
    start_trace(str(tmp_path))
    try:
        _render(scene)
    finally:
        path = stop_trace()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rtc.render", "rtc.chunk", "rtc.primary", "rtc.bounce", "rtc.search",
            "rtc.resolve", "rtc.shade", "rtc.compact"} <= names


def test_counters_hold_the_wrappers_launch_counters(monkeypatch):
    monkeypatch.setattr(brute_mod.search_brute, "launches", 1234)
    snap = counters()
    assert snap["launches.search_brute"] == 1234
    assert {k for k in snap if k.startswith("launches.")} == {
        f"launches.search_{k}" for k in
        ("brute", "bitmask", "packed", "words", "range", "union", "mxu")} | {
        "launches.shade_kernel", "launches.cull_words", "launches.compact_kernel"}
    assert {"integrator.bounces", "integrator.lanes", "search.pairs",
            "shade.kernel_lanes", "shade.torch_lanes"} <= set(snap)
