"""Profiling and observability hooks.

Counterpart of ``raytracingc_tpu/utils/profiling.py``:

* :class:`Profiler`: wall-clock phase timers plus traced-ray accounting,
  printed as one line (the JAX package's text).
* :func:`trace_annotation`: names a region in a profile
  (``torch.profiler.record_function``).
* :func:`start_trace` / :func:`stop_trace`: a ``torch.profiler.profile``
  over the CPU and, where a card is present, CUDA activities, for a window
  of work; :func:`stop_trace` writes a Chrome trace (``chrome://tracing``,
  Perfetto) into the log directory. One trace runs at a time per process,
  as with ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Profiler:
    """Accumulating phase timers: ``with prof.phase("trace"): ...``."""

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    rays: float = 0.0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_rays(self, n: float) -> None:
        self.rays += float(n)

    def summary(self) -> str:
        parts = [
            f"{k}={v:.3f}s/{self.counts[k]}x" for k, v in sorted(self.totals.items())
        ]
        total = sum(self.totals.values())
        if self.rays and total > 0:
            parts.append(f"rays/s={self.rays / total:.3g}")
        return " ".join(parts) or "(no phases recorded)"


def trace_annotation(name: str):
    """Named region in profiles (``with trace_annotation("bounce"): ...``)."""
    return torch.profiler.record_function(name)


# The running trace, (profiler, log_dir); start_trace / stop_trace pair up
# around it as jax.profiler's do.
_trace: tuple[torch.profiler.profile, str] | None = None


def start_trace(log_dir: str) -> None:
    """Begin capturing a trace of the CPU and, with a card, CUDA activity."""
    global _trace
    if _trace is not None:
        raise RuntimeError(f"a trace into {_trace[1]} is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace = (prof, log_dir)


def stop_trace() -> str:
    """End the trace and write it as ``trace_<pid>_<ns>.json`` (Chrome trace
    format) into the log directory; returns the file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running (call start_trace first)")
    prof, log_dir = _trace
    _trace = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
