"""Profiling and observability hooks: spans, counters and traces.

Counterpart of ``raytracingc_tpu/utils/profiling.py``:

* :func:`trace_annotation`: a span, the named region of one layer of the
  program in a running ``torch.profiler`` (spans are named ``rtc.<layer>``).
  With no profiler running it returns one shared no-op context manager and
  records nothing; under a profiler the span is a function-scope
  ``RecordFunction``, an event in the profiler's own stream and clock beside
  the kernels it launches. Unlike a user-scope ``record_function`` it has no
  device-side copy (``gpu_user_annotation``), so a profile's device
  activity holds the kernels, copies and fills alone.
* :data:`COUNTS` and :func:`tally`: counters of the integrator's, the
  search's and the shading's work, always on, filled by plain integer adds
  from values the host already holds (no device sync). The bitmask kernel
  (K2) counts its walked (packet, block) pairs on its card instead.
  :func:`counters` snapshots them with each kernel wrapper's launch
  counter, reading the card's count (the only sync it makes).
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

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

_NO_SPAN = contextlib.nullcontext()

# Counters of work: one per search the integrator makes (primary calls and
# loop iterations), the lanes it adds to the traced-ray count it returns
# (where that amount is a Python int), the ray-triangle pairs handed to the
# brute-force search (every lane given to it, times the live triangles), the
# (packet, block) pairs the bitmask search walks (8 x 128 ray-triangle tests
# each; here the plain version's, the kernel's on its card), the 8-ray
# packets handed to any culling prelude (ceil(R / 8) a call), the lanes of
# the resolve and shading calls (ops/shade.py) by their route: the CUDA
# kernel or the torch composition, and the lanes handed to the integrator's
# compactions (ops/compact.py) by their route.
COUNTS = dict.fromkeys(("integrator.bounces", "integrator.lanes", "search.pairs",
                        "search.bitmask_blocks", "search.cull_packets",
                        "shade.kernel_lanes", "shade.torch_lanes",
                        "compact.kernel_lanes", "compact.torch_lanes"), 0)


def trace_annotation(name: str, **args):
    """Span of one layer (``with trace_annotation("rtc.bounce"): ...``).
    ``args`` (ints, strings) are kept with the span where the profiler
    records inputs (``record_shapes=True``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name, (), args) if args else _RecordFunctionFast(name)


def tally(name: str, n):
    """Add ``n`` to counter ``name`` and return it; a tensor (a count per
    element under ``torch.func.vmap``) adds nothing."""
    if type(n) is int:
        COUNTS[name] += n
    return n


def counters() -> dict:
    """A snapshot of every counter of the program: :data:`COUNTS`, with
    ``search.bitmask_blocks`` the host's and every card's count together,
    and each kernel wrapper's ``.launches`` as ``launches.<wrapper>``."""
    from raytracingc_tpu_torch.ops import (
        compact,
        culling,
        intersect_mxu,
        search_bitmask,
        search_brute,
        search_packed,
        search_range,
        search_union,
        search_words,
        shade,
    )

    out = dict(COUNTS)
    out["search.bitmask_blocks"] += search_bitmask.card_blocks()
    for fn in (search_brute.search_brute, search_bitmask.search_bitmask,
               search_packed.search_packed, search_words.search_words,
               search_range.search_range, search_union.search_union,
               intersect_mxu.search_mxu, shade.shade_kernel, culling.cull_words,
               compact.compact_kernel):
        out[f"launches.{fn.__name__}"] = fn.launches
    return out


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
