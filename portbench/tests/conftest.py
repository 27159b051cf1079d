"""Shared set-up of the benchmark's CPU tests.

    python -m pytest portbench/tests -q

Tests marked ``card`` need a CUDA card and skip without one (decided inside
the test).
"""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"frames": {"width": 24, "height": 16}, "fit": {"width": 16, "height": 16}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    # The port's CPU parity holds lane by lane on one torch thread.
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cell):
    """The cell with its traffic cut to a test's size (the same kind,
    bounces, samples and check)."""
    cell = copy.copy(cell)
    cell.traffic = dict(cell.traffic, **TINY[cell.traffic["kind"]])
    return cell
