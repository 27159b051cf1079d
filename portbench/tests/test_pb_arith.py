"""The arithmetic of the metrics: whole-window rates, the tail, and the
device's busy time and idle gaps from profiler events."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import pytest

from portbench.lib import spec, stats, trace


def test_rate_is_all_rays_over_all_the_window():
    rec = {"window_s": 4.0, "frames": [{"rays": 3_000_000, "wall_s": 1.5},
                                       {"rays": 5_000_000, "wall_s": 2.5}]}
    assert spec._reader("e2e", "rays_per_s")(rec) == 2_000_000.0
    assert spec._reader("e2e", "train_step_s")(rec) is None
    assert spec._reader("e2e", "train_step_s")({"window_s": 3.0, "steps": 12}) == 0.25


def test_p95_is_the_tail_of_every_frame():
    walls = [0.001 * k for k in range(1, 201)]
    rec = {"window_s": sum(walls), "frames": [{"rays": 1, "wall_s": w} for w in walls]}
    got = spec._reader("e2e", "preview_p95_ms")(rec)
    assert got == pytest.approx(statistics.quantiles(walls, n=100, method="inclusive")[94] * 1e3)
    assert 190.0 <= got <= 191.0
    assert stats.percentile([0.5], 95) == 0.5


def test_union_gaps_and_idle_share():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert trace.union_us(iv) == 10 + 5 + 10 + 1 + 1
    assert trace.gaps(iv, -5, 50) == [(-5, 0), (15, 20), (31, 40), (41, 50)]
    span = trace.Span(window_s=2.0, busy_s=0.5, kernels=10, search_s=0.1,
                      device_ops=[], idle_gaps=[], work={"rays": 2_000_000, "frames": 2})
    assert spec._reader("metrics", "device_idle_pct.frame")(span) == 75.0
    assert spec._reader("metrics", "launches_per_mray.frame")(span) == 5.0
    assert spec._reader("metrics", "launches_per_frame.preview")(span) == 5.0
    assert spec._reader("metrics", "search_ms_per_mray.frame")(span) == pytest.approx(50.0)
    assert spec._reader("metrics", "launches_per_step.train")(span) is None
    assert spec._reader("metrics", "device_idle_pct.train")(None) is None


def test_gaps_go_to_the_host_op_that_overlaps_them_most():
    host = [(0, 100, "aten::nonzero", 1), (10, 20, "cudaStreamSynchronize", 1),
            (150, 160, "aten::mul", 1), (150, 400, "autograd", 2)]
    top = trace.outermost(host)
    assert [e[2] for e in top[1]] == ["aten::nonzero", "aten::mul"]
    idle = trace.attribute_gaps([(30, 90), (140, 170), (500, 510)], top)
    assert idle["aten::nonzero"] == pytest.approx(60e-6)
    assert idle["autograd"] == pytest.approx(30e-6)
    assert idle["(no host op)"] == pytest.approx(10e-6)


class _Event:
    def __init__(self, name, dev, start_us, dur_us, tid=1):
        self._v = (name, dev, start_us, dur_us, tid)

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


def test_reduce_events_counts_kernels_search_and_busy():
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    evs = [_Event("aten::add", cpu, 0, 50), _Event("search_brute_kernel<8,false>", cuda, 10, 30),
           _Event("elementwise", cuda, 60, 10), _Event("Memcpy DtoH", cuda, 65, 20),
           _Event("aten::item", cpu, 60, 40)]
    s = trace.reduce_events(evs, 1e-4, {"rays": 10})
    assert s.kernels == 2
    assert s.busy_s == pytest.approx(55e-6)
    assert s.search_s == pytest.approx(30e-6)
    assert s.device_ops[0][0] == "search_brute_kernel<8,false>"
    assert dict(s.idle_gaps) == pytest.approx({"aten::add": 30e-6, "aten::item": 15e-6})
    assert SimpleNamespace(**s.work).rays == 10


@pytest.mark.parametrize("size, fov", [((512, 512), 2.8), ((1920, 1080), 2.8 * 16 / 9),
                                       ((1080, 1920), 2.8)])
def test_the_film_fills_the_longer_side(size, fov):
    from portbench.lib.traffic import camera_fov

    cam = {"focal_length": 0.035, "film": 0.025}
    assert camera_fov(cam, *size) == pytest.approx(fov, rel=1e-12)
