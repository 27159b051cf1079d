#!/usr/bin/env python3
"""Run one benchmark cell of the port (``raytracingc_tpu_torch``) on one card.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Sets up the cell (imports, the CUDA context, the scene, the accel, the
kernel library from its build cache, the cell's own shapes warmed), runs
the measured window of ``--seconds`` seconds, checks what the window
produced against the plain reference, and prints one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from torch.profiler over a steady
part of the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit. The same numbers end
standard error. Exits non-zero, printing no result, without a CUDA card
(or fewer than the cell asks for), and if ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``raytracingc_tpu`` has been imported.

Caches stay inside the checkout, at fixed paths: the port builds its CUDA
library into ``build/raytracingc_tpu_torch/``; ``TRITON_CACHE_DIR`` and
``TORCH_EXTENSIONS_DIR`` point under ``build/portbench/``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="cell name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="measured window")
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def set_cache_dirs(root: str = ROOT):
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, "build", "portbench", sub)


def require_cards(chips: int):
    """Raise unless ``chips`` CUDA cards are visible (no CPU fallback)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is false; no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible; no result")


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0):
    """Set up, measure and check one cell: ``(result, compared)``."""
    import torch

    from portbench.lib.check import CHECKS, verdict
    from portbench.lib.traffic import KINDS

    kind = cell.traffic["kind"]
    cuda = device.type == "cuda"
    if cuda:
        torch.empty(0, device=device)  # the CUDA context, whose peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    load = KINDS[kind](cell.config, cell.traffic, seed, device, trace,
                           keep=cell.check.get("frames", 0))
    load.warm()
    # The reference's seconds in set-up (a fit's target render) are not set-up.
    setup_s = time.perf_counter() - t0 - getattr(load, "reference_s", 0.0)
    record = load.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    load.scene = None  # the program's state; the window's outputs stay
    if cuda:
        torch.cuda.empty_cache()
    numbers, checked = CHECKS[kind](load, record, cell.check)
    correct, compared = verdict(numbers, cell.check["limits"])

    span = record.get("span")
    metrics = {}
    readers = cell.per_layer if trace else cell.end_to_end
    for m in readers:
        value = m.read(span if trace else record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": 0 if correct else checked, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = span.busy_s, span.window_s
        result["breakdown"] = {"device_ops": span.device_ops, "idle_gaps": span.idle_gaps}
    result["checks"] = compared
    return result, compared


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    from portbench.lib.spec import load_cell

    cell = load_cell(args.workload)
    require_cards(cell.chips)
    import torch

    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}; no result", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
