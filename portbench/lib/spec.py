"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell
(``<config>.<traffic>``), its configuration and its traffic mix, and the
metrics. Everything else is found by name under ``portbench/``:

* ``configs/<config>.json``: the deployment (scene file, spheres, camera,
  environment);
* ``traffic/<traffic>.json``: the traffic mix, parameters that the one
  generator (``lib/traffic.py``) reads; its ``kind`` picks the load;
* ``checks/<cell>.json``: what the correctness check samples and the limit
  of every number it compares;
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  end-to-end and per-layer metric, each a ``read(record)`` function that
  returns a number, or ``None`` where it finds nothing to read. Every
  per-layer metric lists the cells it is read in (``workloads``).

A later cell, mix or metric is new files and new entries; no file here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reader(folder: str, name: str):
    """The ``read`` function of ``portbench/<folder>/<name>.py``."""
    path = os.path.join(PKG, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object  # record -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list  # [Metric], setup_s excluded (the harness takes it)
    per_layer: list  # [Metric]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    missing = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if missing:
        raise ValueError(f"per-layer metrics without 'workloads': {missing}")
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(os.path.join(PKG, "configs", f"{w['config']}.json")),
        traffic=_load_json(os.path.join(PKG, "traffic", f"{w['traffic']}.json")),
        check=_load_json(os.path.join(PKG, "checks", f"{name}.json")),
        end_to_end=[Metric(m["name"], m["unit"], _reader("e2e", m["name"]))
                    for m in e2e if m["name"] != "setup_s"],
        per_layer=[Metric(m["name"], m["unit"], _reader("metrics", m["name"]))
                   for m in layer],
    )
