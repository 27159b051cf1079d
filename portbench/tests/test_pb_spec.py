"""Every cell of BENCHMARK.json resolves by name to its files, and the file
keeps to the shape the benchmark's contract asks for."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.lib import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.load_cell(name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert name == f"{w['config']}.{w['traffic']}"
    assert cell.traffic["kind"] in ("frames", "fit")
    assert os.path.isfile(os.path.join(spec.ROOT, cell.config["scene"]))
    assert cell.check["limits"]
    reported = {m.name for m in cell.end_to_end}
    assert len(reported) >= 1 and cell.per_layer
    for m in BENCH["per_layer"]:
        if name in m["workloads"]:
            assert m["moves"] in reported
            assert m["name"] in {x.name for x in cell.per_layer}


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == json.load(open(os.path.join(spec.ROOT, c["file"])))["reduced"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= len(CELLS) // 4


@pytest.mark.parametrize("kind", ["e2e", "metrics"])
def test_every_metric_has_a_reader(kind):
    group = BENCH["end_to_end" if kind == "e2e" else "per_layer"]
    for m in group:
        if m["name"] != "setup_s":
            assert callable(spec._reader(kind, m["name"]))


def test_a_per_layer_metric_without_workloads_is_refused(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    del bench["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="without 'workloads'"):
        spec.load_cell(CELLS[0], root=str(tmp_path))


def _quads(path):
    """``(comment, triangles)`` of each published quad the scene file names."""
    import numpy as np

    from portbench.reference.scene import parse_triangles_txt

    verts = parse_triangles_txt(path)[0]
    quads = [line.split(": ", 1)[1].split() for line in open(path)
             if line.startswith("// ") and ": " in line]
    quads = [np.array(q, np.float32).reshape(4, 3) for q in quads
             if len(q) == 12 and not any(c.isalpha() for c in "".join(q))]
    return quads, verts


def test_the_scene_file_is_the_published_quads_turned():
    import numpy as np

    path = os.path.join(spec.ROOT, "portbench", "configs", "cornell_box.txt")
    quads, verts = _quads(path)
    assert len(verts) == 2 * len(quads) == 38
    turn = np.array([-1.0, -1.0, 1.0], np.float32)
    for k, q in enumerate(quads):
        v = q * turn
        np.testing.assert_array_equal(verts[2 * k], v[[0, 1, 2]])
        np.testing.assert_array_equal(verts[2 * k + 1], v[[0, 2, 3]])
