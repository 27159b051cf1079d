"""The device's idle time put down to the program's layers, from profiler events.

The program (``raytracingc_tpu_torch``) opens a span named ``rtc.<layer>``
around each layer's work while a torch.profiler runs: a host event in the
profiler's own stream, on the clock of the kernels. Over one capture
``[lo, hi]`` this module gives, for each span name,

* the spans lying wholly inside the capture: their count, inclusive host
  seconds, and self seconds (less the part their ``rtc.`` children on the
  same thread cover);
* the device's idle seconds, two ways: **innermost**, each instant of an
  idle gap put down to the most recently opened span open at that instant,
  on any thread, else to ``(outside)``; and **inclusive**, each instant put
  down to every span name open then.

The gaps are ``trace.gaps`` of the device intervals over ``[lo, hi]``, those
of the harness's idle breakdown. :func:`split` sets the spans (and any
device-side copy of one) apart from the other events, so that the harness's
reduction of the rest reads what it reads without them. :func:`readings`
gives the per-layer numbers a cell reads from a reduced capture and the
program's counters.
"""

from __future__ import annotations

import collections

from portbench.lib.trace import gaps

PREFIX = "rtc."
OUTSIDE = "(outside)"

# The closest-hit search's bound (PERF.md §6): 61 FP32 operations a
# Möller–Trumbore test (``csrc/mt.cuh``, built with ``--fmad=false``) at the
# H100's 33.4e12 FP32 operations a second outside the tensor cores (its
# 67 TFLOP/s counts a fused multiply-add as two).
MT_OPS = 61
FP32_OPS_PER_S = 33.4e12

# Innermost idle summed per layer: the spans of each.
LAYERS = {
    "idle_pct_search": ("rtc.search", "rtc.cull"),
    "idle_pct_shade": ("rtc.resolve", "rtc.shade"),
    "idle_pct_integrator": ("rtc.bounce", "rtc.primary", "rtc.compact", "rtc.chunk"),
}


def split(events):
    """``(spans, rest)``: the events whose name starts with ``rtc.``, host
    and device-side alike, and every other event."""
    spans, rest = [], []
    for e in events:
        (spans if e.name().startswith(PREFIX) else rest).append(e)
    return spans, rest


def _nesting(spans):
    """Each span's parent index (the innermost span of its thread holding
    it), or None."""
    parent = [None] * len(spans)
    by_thread = collections.defaultdict(list)
    for i, s in enumerate(spans):
        by_thread[s[3]].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (spans[i][0], -spans[i][1]))
        stack = []
        for i in idx:
            while stack and spans[stack[-1]][1] <= spans[i][0]:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)
    return parent


def reduce_layers(spans, device, lo: float, hi: float) -> dict:
    """Per-span statistics and idle of one capture. ``spans`` are host
    ``(start_us, end_us, name, thread)``, ``device`` the ``(start_us,
    end_us)`` intervals of the device's kernels, copies and fills; spans not
    wholly inside ``[lo, hi]`` are left out. Returns ``{"spans": {name:
    {"count", "host_s", "self_s"}}, "idle_innermost_s": {name or
    (outside): s}, "idle_inclusive_s": {name: s}, "idle_s": s}``."""
    spans = [s for s in spans if lo <= s[0] and s[1] <= hi]
    parent = _nesting(spans)
    stats = {}
    for i, (a, b, name, _) in enumerate(spans):
        st = stats.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0})
        st["count"] += 1
        st["host_s"] += (b - a) * 1e-6
        st["self_s"] += (b - a) * 1e-6
        if parent[i] is not None:
            stats[spans[parent[i]][2]]["self_s"] -= (b - a) * 1e-6

    idle = gaps(device, lo, hi)
    inner, inclusive = collections.Counter(), collections.Counter()
    points = sorted({lo, hi, *(x for g in idle for x in g),
                     *(x for s in spans for x in s[:2])})
    opens = sorted(range(len(spans)), key=lambda i: spans[i][0])
    closes = sorted(range(len(spans)), key=lambda i: spans[i][1])
    live, oi, ci, gi = set(), 0, 0, 0
    for a, b in zip(points, points[1:]):
        while oi < len(opens) and spans[opens[oi]][0] <= a:
            live.add(opens[oi])
            oi += 1
        while ci < len(closes) and spans[closes[ci]][1] <= a:
            live.discard(closes[ci])
            ci += 1
        while gi < len(idle) and idle[gi][1] <= a:
            gi += 1
        if gi == len(idle) or idle[gi][0] > a:
            continue  # the device is busy over [a, b]
        dt = (b - a) * 1e-6
        if not live:
            inner[OUTSIDE] += dt
            continue
        top = max(live, key=lambda i: (spans[i][0], -spans[i][1]))
        inner[spans[top][2]] += dt
        for name in {spans[i][2] for i in live}:
            inclusive[name] += dt
    return {"spans": stats, "idle_innermost_s": dict(inner),
            "idle_inclusive_s": dict(inclusive),
            "idle_s": sum(b - a for a, b in idle) * 1e-6}


def readings(window_s: float, kernels: int, search_s: float, layers: dict | None,
             counts: dict | None) -> dict:
    """The per-layer numbers of one capture: each ``idle_pct_*`` (innermost
    idle of the layer's spans, or inclusive idle of the training step's
    forward and backward, over the window, in %), launches and lanes a
    bounce, the search's share of its bound (brute-route pairs over the
    ``search_`` kernels' device time, in %) and the backward's host time
    over the forward's. A number whose inputs the capture lacks is left
    out."""
    out = {}
    if layers and window_s > 0:
        inner, incl = layers["idle_innermost_s"], layers["idle_inclusive_s"]
        for metric, names in LAYERS.items():
            if any(n in layers["spans"] for n in names):
                out[metric] = 100.0 * sum(inner.get(n, 0.0) for n in names) / window_s
        for part in ("forward", "backward"):
            if f"rtc.train.{part}" in incl:
                out[f"idle_pct_{part}"] = 100.0 * incl[f"rtc.train.{part}"] / window_s
        host = {k: v["host_s"] for k, v in layers["spans"].items()}
        if host.get("rtc.train.forward"):
            out["backward_over_forward"] = (host.get("rtc.train.backward", 0.0)
                                            / host["rtc.train.forward"])
    bounces = (counts or {}).get("integrator.bounces")
    if bounces:
        out["launches_per_bounce"] = kernels / bounces
        out["lanes_per_bounce"] = counts["integrator.lanes"] / bounces
    pairs = (counts or {}).get("search.pairs")
    if pairs and search_s > 0:
        out["search_bound_pct"] = 100.0 * pairs * MT_OPS / FP32_OPS_PER_S / search_s
    return out
