"""The device's idle time put down to the program's spans (``lib/layers.py``),
on synthetic profiler events, and on the card the spans' place on the
device trace's clock."""

from __future__ import annotations

import pytest

from portbench.lib import layers, trace


class _Event:
    def __init__(self, name, dev, start_us, dur_us, tid=1, annotation=False):
        self._v = (name, dev, start_us, dur_us, tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return int(self._v[2] * 1000)

    def duration_ns(self):
        return int(self._v[3] * 1000)

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_setting_the_spans_aside_leaves_every_field_as_without_them():
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    plain = [_Event("aten::add", cpu, 0, 50), _Event("search_brute_kernel<8,false>", cuda, 10, 30),
             _Event("elementwise", cuda, 60, 10), _Event("Memcpy DtoH", cuda, 65, 20),
             _Event("aten::item", cpu, 60, 40), _Event("aten::mul", cpu, 120, 5, tid=2)]
    spans = [_Event("rtc.render", cpu, -5, 140), _Event("rtc.search", cpu, 5, 40),
             _Event("rtc.search", cuda, 10, 30, annotation=True),
             _Event("rtc.shade", cuda, 60, 25, annotation=True)]
    got_spans, rest = layers.split(plain[:3] + spans + plain[3:])
    assert got_spans == spans and rest == plain
    want = trace.reduce_events(plain, 2e-4, {"rays": 10})
    assert trace.reduce_events(rest, 2e-4, {"rays": 10}) == want
    # Left in, the device-side copies read as kernels and busy time.
    assert trace.reduce_events(plain + spans, 2e-4, {"rays": 10}).kernels == want.kernels + 2


def test_idle_goes_to_the_innermost_span_and_to_every_open_one():
    # Device busy over [10, 20] and [60, 70]; the capture is [0, 100].
    device = [(10, 20), (60, 70)]
    spans = [(0, 100, "rtc.render", 1), (0, 40, "rtc.primary", 1),
             (5, 30, "rtc.search", 1), (30, 40, "rtc.resolve", 1),
             (50, 90, "rtc.train.backward", 1),
             # A later span on another thread is the innermost while it is open.
             (80, 95, "rtc.shade", 2)]
    got = layers.reduce_layers(spans, device, 0, 100)
    inner = got["idle_innermost_s"]
    assert inner == pytest.approx({
        "rtc.primary": 5e-6, "rtc.search": 5e-6 + 10e-6, "rtc.resolve": 10e-6,
        "rtc.render": 10e-6 + 5e-6, "rtc.train.backward": 10e-6 + 10e-6,
        "rtc.shade": 15e-6})
    incl = got["idle_inclusive_s"]
    assert incl["rtc.render"] == pytest.approx(80e-6)
    assert incl["rtc.train.backward"] == pytest.approx(30e-6)
    assert incl["rtc.shade"] == pytest.approx(15e-6)
    assert incl["rtc.primary"] == pytest.approx(30e-6)
    assert got["idle_s"] == pytest.approx(80e-6)
    stats = got["spans"]
    assert stats["rtc.primary"] == pytest.approx({"count": 1, "host_s": 40e-6, "self_s": 5e-6})
    assert stats["rtc.render"]["self_s"] == pytest.approx((100 - 40 - 40) * 1e-6)
    assert stats["rtc.shade"]["self_s"] == pytest.approx(15e-6)


@pytest.mark.parametrize("lo, hi", [(0, 100), (-20, 130), (15, 85)])
def test_layers_and_outside_add_up_to_the_idle(lo, hi):
    device = [(10, 20), (25, 26), (60, 70)]
    spans = [(s, s + 12, name, tid) for s, name, tid in
             ((0, "rtc.chunk", 1), (3, "rtc.bounce", 1), (40, "rtc.shade", 1),
              (44, "rtc.compact", 2), (90, "rtc.search", 1))]
    got = layers.reduce_layers(spans, device, lo, hi)
    assert sum(got["idle_innermost_s"].values()) == pytest.approx(got["idle_s"])
    assert got["idle_s"] == pytest.approx(
        sum(b - a for a, b in trace.gaps(device, lo, hi)) * 1e-6)


def test_spans_cut_by_the_capture_are_left_out():
    got = layers.reduce_layers([(-5, 30, "rtc.train.update", 1), (10, 20, "rtc.train.refresh", 1),
                                (90, 120, "rtc.train.step", 1)], [(40, 50)], 0, 100)
    assert set(got["spans"]) == {"rtc.train.refresh"}
    assert got["idle_innermost_s"] == pytest.approx({"rtc.train.refresh": 10e-6,
                                                     layers.OUTSIDE: 80e-6})


def test_readings():
    lay = layers.reduce_layers(
        [(0, 50, "rtc.train.forward", 1), (50, 90, "rtc.train.backward", 1),
         (10, 20, "rtc.search", 1), (30, 35, "rtc.shade", 1), (60, 70, "rtc.compact", 1)],
        [(40, 50)], 0, 100)
    counts = {"integrator.bounces": 4, "integrator.lanes": 1000, "search.pairs": 10 ** 9}
    got = layers.readings(1e-4, 200, 1e-3, lay, counts)
    assert got == pytest.approx({
        "idle_pct_search": 10.0, "idle_pct_shade": 5.0, "idle_pct_integrator": 10.0,
        "idle_pct_forward": 40.0, "idle_pct_backward": 40.0,
        "backward_over_forward": 0.8, "launches_per_bounce": 50.0, "lanes_per_bounce": 250.0,
        "search_bound_pct": 100.0 * 1e9 * 61 / 33.4e12 / 1e-3})
    assert layers.readings(1e-4, 200, 1e-3, None, None) == {}
    assert layers.readings(1e-4, 200, 0.0, None, {"search.pairs": 5}) == {}


@pytest.mark.card
def test_search_kernels_launch_inside_search_spans():
    """A traced preview frame on the card: each ``search_`` kernel's launch
    (the runtime call linked to it by correlation id) lies inside an
    ``rtc.search`` span of the launching thread, on the profiler's clock."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.lib import spec
    from portbench.lib.traffic import Frames

    cell = spec.load_cell("cornell.preview128")
    load = Frames(cell.config, cell.traffic, 2**31 + 5, torch.device("cuda", 0), False)
    load.warm()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        load._frame(0)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in events if e.name() == "rtc.search" and e.device_type() == DeviceType.CPU]
    launch = {e.correlation_id(): e for e in events
              if e.device_type() == DeviceType.CPU and "aunch" in e.name()}
    kernels = [e for e in events
               if e.device_type() == DeviceType.CUDA and "search_" in e.name()]
    assert spans and len(kernels) == len(spans)
    for k in kernels:
        rt = launch[k.correlation_id()]
        assert any(a <= rt.start_ns() and rt.start_ns() + rt.duration_ns() <= b
                   and tid == rt.start_thread_id() for a, b, tid in spans), k.name()
