"""Failure detection and recovery for long renders.

Counterpart of ``raytracingc_tpu/utils/resilient.py``. Long renders run as
checkpointed sample batches (``render/progressive.py``), so recovery is
restart-and-resume. :func:`render_resilient` is the supervision loop: run a
checkpointed render, catch a runtime failure (``RuntimeError``, which
covers ``torch.cuda.OutOfMemoryError``, torch's accelerator errors and the
kernels' ``CudaError``), back off, and resume from the last completed batch
with bounded retries and a progress watchdog that refuses to "retry" when
no batch completes (a deterministic failure, not a transient one).

A sticky CUDA error (an illegal address, a kernel fault) leaves the
process's CUDA context unusable: every later call in the process fails
too. The retries then make no progress and the watchdog raises
:class:`RenderFailure` once they are spent. That is the intended outcome,
not a hidden fallback: recovering from such an error takes a new process,
which resumes from the checkpoint.
"""

from __future__ import annotations

import time
from typing import Callable


class RenderFailure(RuntimeError):
    """A render failed permanently (retries exhausted or no progress)."""


def render_resilient(
    render_batches: Callable[[], tuple],
    *,
    progress: Callable[[], int],
    max_retries: int = 3,
    backoff_s: float = 2.0,
    on_failure: Callable[[Exception, int], None] | None = None,
):
    """Supervise ``render_batches`` (a checkpointed render closure).

    ``render_batches()`` runs (or resumes) the render and returns its result;
    ``progress()`` reports a monotone completion counter (e.g. samples done,
    read from the checkpoint) so the supervisor can tell transient failures
    (progress advanced since the last attempt: the retry budget refreshes)
    from deterministic ones (no progress: fail after ``max_retries``).
    """
    retries_left = max_retries
    last_progress = progress()
    attempt = 0
    while True:
        try:
            return render_batches()
        except RuntimeError as e:  # device and runtime failures
            attempt += 1
            now = progress()
            if now > last_progress:
                retries_left = max_retries  # forward progress: refresh budget
                last_progress = now
            else:
                retries_left -= 1
            if on_failure is not None:
                on_failure(e, attempt)
            if retries_left < 0:
                raise RenderFailure(
                    f"render failed after {attempt} attempts with no progress "
                    f"since batch counter {last_progress}"
                ) from e
            time.sleep(backoff_s * (2 ** min(attempt - 1, 4)))
