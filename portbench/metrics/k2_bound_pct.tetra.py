"""The bitmask search kernel's (K2's) share of its FP32 bound in the traced
frames, in %: the least time the card could take for the ray-triangle
tests of the (packet, block) pairs it walked, 8 x 128 tests of 61 FP32
operations a pair at 33.4e12 operations/s (un-fused, ``--fmad=false``;
PERF.md's kernel table), over the device time of the search kernels.

The pairs are the program's counter ``search.bitmask_blocks`` (b), which
``counters()`` reads from the card once the window has closed. The span
carries no counter deltas of its own, so the span's pairs are the process's
pairs a traced ray, b over ``integrator.lanes`` (the warm-up frame and the
window: the same camera and shapes), times the span's rays. A ``Span``
that carried the counters' change over the traced frames would make the
reading exact. ``None`` where the program has no such counter or the span
no search time.
"""

OPS_A_PAIR = 8 * 128 * 61
FP32_OPS_S = 33.4e12


def read(span, counts=None):
    rays = span.work.get("rays") if span is not None else None
    if not rays or span.search_s <= 0:
        return None
    if counts is None:
        from raytracingc_tpu_torch.utils.profiling import counters

        counts = counters()
    blocks, lanes = counts.get("search.bitmask_blocks"), counts.get("integrator.lanes")
    if not blocks or not lanes:
        return None
    bound_s = blocks / lanes * rays * OPS_A_PAIR / FP32_OPS_S
    return 100.0 * bound_s / span.search_s
