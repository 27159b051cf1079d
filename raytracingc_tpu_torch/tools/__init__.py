"""Measurement tools of the port, each run as ``python -m
raytracingc_tpu_torch.tools.<name>``: ``union_walk_ab`` (K9, program-level
union culling against the production search), ``smem_probe`` (K10, the
largest shared-memory table a kernel can hold), ``packet_sweep`` (the
packet kernels K2, K3, the range kernel K4, K5 and the words kernel K6, K7
timed on their ray sets)
and ``chunk_profile``
(where one pixel chunk's device time goes). ``packets`` holds the seeded
packet workloads they, chip_smoke.py and the tests share. Importing one runs
nothing.
"""

import contextlib
import os


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current CUDA stream, by
    CUDA events over ``iters`` calls after up to 3 warm-up calls."""
    import torch

    for _ in range(min(3, iters)):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


@contextlib.contextmanager
def knobs_set(env: dict):
    """Set the environment variables ``env`` (the ``RTC_*`` knobs) for the
    body of a ``with``, restoring each one's previous value after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
