#!/usr/bin/env python3
"""A cell's traced run with the device's idle time put down to the program's
layers.

    python3 portbench/trace_layers.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``run.py --trace 1`` does, on one card, with a capture that
keeps the profiler's raw events and the program's counters
(``raytracingc_tpu_torch.utils.profiling.counters``) over the traced span,
and prints one JSON object as the last line of standard output:

* ``result``: what ``run.py --trace 1`` prints, from all of the events;
* ``without_spans``: the harness's reduction (``lib/trace.reduce_events``)
  of the events less the program's ``rtc.`` spans, and ``span_events``, how
  many of those were host and device events;
* ``layers``: ``lib/layers.reduce_layers`` of the capture, ``counters``:
  their change over the capture, ``readings``: ``lib/layers.readings``;
* ``user_annotations``: the device-side user annotations by name
  (``gpu_user_annotation`` events, such as torch's own optimizer step's),
  which the harness's reduction counts as kernels and busy time;
* ``host_us_per_launch``: the traced window over its kernels;
* ``gc``: the Python garbage collections inside the traced window, their
  count and seconds (a long one holds the device idle inside whatever span
  is open).

The benchmark's own runs never run this. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/trace_layers.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from portbench import run

    run.set_cache_dirs()
    import torch
    from torch.autograd import DeviceType

    from portbench.lib import layers, spec, trace, traffic
    from raytracingc_tpu_torch.utils.profiling import counters

    cell = spec.load_cell(args.workload)
    run.require_cards(cell.chips)
    captures = []
    gc_seen = {"n": 0, "s": 0.0, "t0": 0.0, "on": False}

    def time_gc(phase, info):
        if not gc_seen["on"]:
            return
        if phase == "start":
            gc_seen["t0"] = time.perf_counter()
        else:
            gc_seen["n"] += 1
            gc_seen["s"] += time.perf_counter() - gc_seen["t0"]

    gc.callbacks.append(time_gc)

    class LayerCapture(trace.Capture):
        def start(self):
            self.counts0 = counters()
            super().start()
            gc_seen["on"] = True

        def stop(self, work: dict):
            torch.cuda.synchronize()
            window = time.perf_counter() - self._t0
            gc_seen["on"] = False
            self._prof.stop()
            counts = counters()
            events = list(self._prof.profiler.kineto_results.events())
            self._prof = None
            self.span = trace.reduce_events(events, window, work)
            spans, rest = layers.split(events)
            self.without = trace.reduce_events(rest, window, work)
            host = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name(),
                     e.start_thread_id())
                    for e in spans if e.device_type() == DeviceType.CPU]
            device = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                      for e in rest if e.device_type() == DeviceType.CUDA]
            # The capture's edges: its first and last event, spans included.
            times = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                     for e in events if e.device_type() in (DeviceType.CPU, DeviceType.CUDA)]
            lo, hi = min(t[0] for t in times), max(t[1] for t in times)
            self.layers = layers.reduce_layers(host, device, lo, hi)
            self.counts = {k: counts[k] - self.counts0.get(k, 0) for k in counts}
            self.span_events = collections.Counter(str(e.device_type()) for e in spans)
            self.annotations = collections.Counter(
                e.name() for e in events
                if e.device_type() == DeviceType.CUDA and e.is_user_annotation())
            captures.append(self)

    traffic.Capture = LayerCapture
    result, _ = run.run_cell(cell, args.seed, args.seconds, True, torch.device("cuda", 0))
    cap = captures[-1]
    w = cap.without
    out = {
        "workload": cell.name, "seed": args.seed, "result": result,
        "without_spans": {"window_s": w.window_s, "busy_s": w.busy_s, "kernels": w.kernels,
                          "search_s": w.search_s, "idle_gaps": w.idle_gaps},
        "span_events": dict(cap.span_events),
        "layers": cap.layers, "counters": cap.counts,
        "readings": layers.readings(w.window_s, w.kernels, w.search_s, cap.layers,
                                    cap.counts),
        "user_annotations": dict(cap.annotations),
        "host_us_per_launch": w.window_s / w.kernels * 1e6 if w.kernels else None,
        "gc": {"count": gc_seen["n"], "seconds": gc_seen["s"]},
        "work": w.work,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
