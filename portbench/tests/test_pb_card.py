"""One short run of a cell on the card, through the command the benchmark
gives (skips without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.lib import spec


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cornell.preview128",
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
