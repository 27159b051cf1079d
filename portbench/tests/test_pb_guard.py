"""Nothing the benchmark runs imports JAX or the JAX package, and the
measurement entry refuses to run without a card."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.lib import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "raytracingc_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules():
    for base, _, files in os.walk(spec.PKG):
        yield from (os.path.join(base, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


def test_whole_top_level_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracingc_tpu_torch_like", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raytracingc_tpu.render", object())
    assert run.forbidden_modules() == ["raytracingc_tpu"]


def test_the_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cornell.preview128",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_the_run_refuses_fewer_cards_than_the_cell_asks(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run.require_cards(1)
    with pytest.raises(SystemExit, match="needs 4 cards"):
        run.require_cards(4)
