"""Measurement tools of the port, each run as ``python -m
raytracingc_tpu_torch.tools.<name>``: ``union_walk_ab`` (K9, program-level
union culling against the production search), ``smem_probe`` (K10, the
largest shared-memory table a kernel can hold), ``packet_sweep`` (the
packet kernels K2, K3, the range kernel K4, K5 and the words kernel K6, K7
timed on their ray sets),
``chunk_profile`` (where one pixel chunk's device time goes),
``dispatch_calibration`` (the brute/packet crossover that sets
``RTC_BRUTE_MAX``: rays/s of each leg on box_scene tessellations) and
``granule_analysis`` (the dead MT work inside set granule bits of the words
route at streamed scale) and ``sass_loop`` (issued instructions per MT test
in a search kernel's SASS). ``packets`` holds the seeded
packet workloads they, chip_smoke.py and the tests share. Importing one runs
nothing. This module holds what the tools and the examples share: the
in-repo scene, the ``--device`` check, timing (events, and a call's
host / device split), the card's name and the knobs' context.
"""

import contextlib
import os
import subprocess
import time

BOX_SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                         "examples", "box_scene.txt")


def device_arg(name) -> "torch.device":
    """A ``--device`` choice (a name or a device) as a device; ``cuda``
    without a card raises, it never falls back to the CPU."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return device


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


def split_times(call, kernel: str) -> dict:
    """A kernel's times at one launch, ``call()`` calling its wrapper once:
    ``ms`` the call by CUDA events over 50 calls (host included),
    ``host`` the host's milliseconds per call (200 calls on a clock with no
    sync between them: the launch queue holds them, so a slower device does
    not stall the host), ``profiler`` the device duration per launch of the
    CUDA kernels whose name holds ``kernel``, from torch.profiler over 20
    calls."""
    import torch

    out = {"ms": cuda_ms(call, 50)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        call()
    out["host"] = (time.perf_counter() - t) / 200 * 1e3
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "device_time_total", 0) or getattr(
        e, "cuda_time_total", 0)
    durs = [dev_us(e) / max(e.count, 1) for e in prof.key_averages()
            if kernel in e.key and dev_us(e) > 0]
    out["profiler"] = durs[0] / 1e3 if durs else float("nan")
    return out


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or "" where
    there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0]


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
