"""A traced part of the window: torch.profiler's events, read in memory.

:class:`Capture` runs torch.profiler (host ops and device activity) over a
span of the window that the traffic generator chooses, and reduces its
events to a :class:`Span`: the device's busy time (the union of its kernel,
copy and fill intervals), the kernels launched and their time by name, the
closest-hit search kernels' time (kernels whose name holds ``search_``), and
the idle gaps of the device, each put down to the host op that overlapped it
most. The raw events are read from the profiler's results directly, without
building its per-event Python objects, and no trace file is written.
"""

from __future__ import annotations

import collections
import dataclasses
import time

TOP = 10  # entries of each breakdown list


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The parts of ``[lo, hi]`` that no interval covers, in order."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def outermost(events):
    """Per thread, the events that no other event of the thread contains:
    ``{thread: [(start, end, name)]}``, each list in time order."""
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[e[3]].append(e[:3])
    out = {}
    for tid, evs in by_thread.items():
        evs.sort(key=lambda e: (e[0], -e[1]))
        top, end = [], float("-inf")
        for s, t, name in evs:
            if s >= end:
                top.append((s, t, name))
                end = t
        out[tid] = top
    return out


def attribute_gaps(gap_list, host) -> dict:
    """Seconds of device idle put down to the host op that overlaps each gap
    most (``"(no host op)"`` where none does)."""
    total = collections.Counter()
    ptr = {tid: 0 for tid in host}
    for g0, g1 in gap_list:
        best, best_name = 0.0, "(no host op)"
        for tid, evs in host.items():
            i = ptr[tid]
            while i < len(evs) and evs[i][1] <= g0:
                i += 1
            ptr[tid] = i
            j = i
            while j < len(evs) and evs[j][0] < g1:
                overlap = min(evs[j][1], g1) - max(evs[j][0], g0)
                if overlap > best:
                    best, best_name = overlap, evs[j][2]
                j += 1
        total[best_name] += (g1 - g0) * 1e-6
    return total


@dataclasses.dataclass
class Span:
    """What one traced span holds. Times in seconds."""

    window_s: float
    busy_s: float
    kernels: int
    search_s: float
    device_ops: list  # [[name, seconds]] the kernels that took most time
    idle_gaps: list  # [[host op, seconds]] the longest idle by host op
    work: dict  # what the generator did in the span: rays, frames, steps


class Capture:
    """torch.profiler over one span: ``start()``, ``stop(work)``, then
    ``span``."""

    def __init__(self):
        self.span = None
        self._prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, work: dict):
        import torch

        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        self.span = reduce_events(self._prof.profiler.kineto_results.events(),
                                  window, work)
        self._prof = None


def reduce_events(events, window_s: float, work: dict) -> Span:
    """Reduce raw profiler events to a :class:`Span`."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            device.append((s, t, e.name()))
        elif e.device_type() == DeviceType.CPU:
            host.append((s, t, e.name(), e.start_thread_id()))
    if not device:
        raise RuntimeError("torch.profiler recorded no device activity")
    kernels = [d for d in device if not d[2].startswith(("Memcpy", "Memset"))]
    by_name = collections.Counter()
    for s, t, name in device:
        by_name[name] += (t - s) * 1e-6
    lo = min(min(d[0] for d in device), min((h[0] for h in host), default=float("inf")))
    hi = max(max(d[1] for d in device), max((h[1] for h in host), default=float("-inf")))
    spans = [(s, t) for s, t, _ in device]
    idle = attribute_gaps(gaps(spans, lo, hi), outermost(host))
    return Span(
        window_s=window_s,
        busy_s=union_us(spans) * 1e-6,
        kernels=len(kernels),
        search_s=sum(t - s for s, t, name in kernels if "search_" in name) * 1e-6,
        device_ops=[[n, v] for n, v in by_name.most_common(TOP)],
        idle_gaps=[[n, v] for n, v in idle.most_common(TOP)],
        work=dict(work),
    )
