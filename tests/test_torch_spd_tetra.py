"""The SPD ``tetra`` deployment of the benchmark on the CPU.

* Its generator (``portbench/configs/make_spd_tetra.py``): 4^SF tetrahedra
  of four triangles, integer vertices, outward faces, sub-tetrahedra that
  meet only at vertices, and the committed scene file as its output.
* The port against the benchmark's plain reference (``portbench/reference``)
  on the scene at size factors 5 and 6: equal images and ray counts, every
  search on the bitmask route (K2, here its plain version).
* The counters of that route's work: ``search.bitmask_blocks``, the
  (packet, block) pairs walked, is the popcount of the culling words;
  ``search.cull_packets`` is ceil(R / 8) a culling call; the packed route
  (K3), which shares K2's walk, counts nothing there and keeps its bits.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from portbench.lib import check, spec, traffic
from portbench.reference.scene import parse_triangles_txt
from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops import search_bitmask as bitmask_mod
from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute_reference
from raytracingc_tpu_torch.utils.profiling import COUNTS, counters

CELL = "spd_tetra.frame1080"
SEED = 2**31 + 4099
SCENE = os.path.join(spec.ROOT, "portbench", "configs", "spd_tetra.txt")


def _generator():
    path = os.path.join(spec.ROOT, "portbench", "configs", "make_spd_tetra.py")
    mod_spec = importlib.util.spec_from_file_location("make_spd_tetra", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


make = _generator()


@pytest.fixture(autouse=True)
def _one_thread():
    # The port's CPU parity with the reference holds lane by lane on one
    # torch thread.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tetrahedra(verts):
    """``(centers [N, 3], half-size)`` of the file's tetrahedra (four
    consecutive faces each), turned back into the source's frame."""
    quads = verts.reshape(-1, 12, 3).astype(np.int64)
    centers = quads.sum(1) // 12  # every vertex is in three of the four faces
    s = int(np.abs(quads[0, 0] - centers[0]).max())
    x, y, z = centers.T
    return np.stack([x, z, -y], 1), s


@pytest.mark.parametrize("sf", range(1, 7))
def test_tetra_has_four_triangles_a_tetrahedron(sf):
    tris = make.triangles(sf)
    assert len(tris) == 4 ** sf * 4
    assert len(set(tris)) == len(tris)


def test_every_vertex_is_an_integer_in_the_scaled_root():
    verts = parse_triangles_txt(SCENE)[0]
    assert verts.shape == (16384, 3, 3)
    assert np.array_equal(verts, np.round(verts))
    assert verts.min() == -64 and verts.max() == 64


def test_every_face_points_away_from_its_tetrahedron():
    verts, normals = parse_triangles_txt(SCENE)[:2]
    quads = verts.reshape(-1, 4, 3, 3).astype(np.float64)
    centers = quads.reshape(-1, 12, 3).sum(1) / 12.0
    outward = np.cross(quads[:, :, 1] - quads[:, :, 0], quads[:, :, 2] - quads[:, :, 0])
    away = quads[:, :, 0] - centers[:, None]
    assert ((outward * away).sum(-1) > 0).all()
    assert ((normals.reshape(-1, 4, 3) * away).sum(-1) > 0).all()


@pytest.mark.parametrize("sf", [3, 5])
def test_sub_tetrahedra_meet_only_at_vertices(sf, tmp_path):
    """Every leaf is a translate of one tetrahedron T, so two leaves'
    interiors are disjoint iff their offset lies outside the interior of
    T - T, the cuboctahedron |x| + |y| + |z| <= 4s, max |x_i| <= 2s; they
    touch at one point, a vertex of both, iff the offset is one of its
    twelve vertices, a permutation of (+-2s, +-2s, 0)."""
    path = tmp_path / "tetra.txt"
    path.write_text(make.scene_text(sf))
    centers, s = _tetrahedra(parse_triangles_txt(str(path))[0])
    assert len(centers) == 4 ** sf
    delta = np.abs(centers[:, None] - centers[None]).astype(np.int32)
    l1, linf = delta.sum(-1), delta.max(-1)
    apart = (l1 > 4 * s) | (linf > 2 * s)
    vertex = (np.sort(delta, -1) == np.array([0, 2 * s, 2 * s])).all(-1)
    np.fill_diagonal(apart, True)
    assert (apart | vertex).all()
    assert vertex.any()  # the leaves do touch


def test_the_committed_scene_is_the_generators_output():
    with open(SCENE) as fh:
        assert fh.read() == make.scene_text(6)


def _load(sf, tmp_path, width=24, height=16):
    """The cell's frames load on the CPU at a test's size, on the scene at
    size factor ``sf``."""
    cell = spec.load_cell(CELL)
    config = copy.deepcopy(cell.config)
    if sf != 6:
        path = tmp_path / f"tetra{sf}.txt"
        path.write_text(make.scene_text(sf))
        config["scene"] = os.path.relpath(path, spec.ROOT)
    mix = dict(cell.traffic, width=width, height=height)
    return cell, traffic.Frames(config, mix, SEED, torch.device("cpu"), False,
                                keep=cell.check["frames"])


@pytest.mark.parametrize("sf", [5, 6])
def test_the_port_equals_the_reference_on_the_k2_route(sf, tmp_path, monkeypatch):
    cell, load = _load(sf, tmp_path)
    assert cell.traffic["spp"] == 2 and cell.traffic["max_bounce"] == 8
    assert search.route(load.scene.n_triangles, load.scene.accel.n_blocks,
                        search.Knobs.read()) == search.Route("bitmask", "K2")
    calls = {"bitmask": 0, "brute": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(search, "search_bitmask", spy("bitmask", search.search_bitmask))
    monkeypatch.setattr(search, "search_brute", spy("brute", search.search_brute))
    record = load.window(0.0)
    assert calls["bitmask"] > 1 and calls["brute"] == 0
    numbers, _ = check.check_frames(load, record, dict(cell.check, pixel_share=1.0))
    assert numbers == {"mismatch_share": 0.0, "ray_count_gap": 0.0}


@pytest.fixture(scope="module")
def counted_render():
    """One tiny frame of the cell on the CPU with the culling words and
    packet counts seen on their way to the search: ``(counter deltas,
    popcounts, rays a culling call)``."""
    _, load = _load(6, None, width=16, height=16)
    popcounts, rays = [], []
    masks = culling.packet_block_masks

    def block_masks(o, d, alive, accel):
        rays.append(o.shape[0])
        words = masks(o, d, alive, accel)
        popcounts.append(int(bitmask_table(words, accel.n_blocks).sum()))
        return words

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(culling, "packet_block_masks", block_masks)
        before = counters()
        load.window(0.0)
        after = counters()
    return {k: after[k] - before[k] for k in after}, popcounts, rays


def test_bitmask_blocks_are_the_popcount_of_the_culling_words(counted_render):
    delta, popcounts, _ = counted_render
    assert len(popcounts) == delta["integrator.bounces"] > 1
    assert delta["search.bitmask_blocks"] == sum(popcounts) > 0
    assert delta["search.pairs"] == 0  # nothing went to the brute search


def test_cull_packets_are_ceil_r_over_8_a_call(counted_render):
    delta, _, rays = counted_render
    assert len(rays) == delta["integrator.bounces"]
    assert delta["search.cull_packets"] == sum(-(-r // 8) for r in rays) > 0


def test_counters_add_the_cards_block_count(monkeypatch):
    # A CPU tensor stands in for a card's counter.
    monkeypatch.setattr(bitmask_mod, "_card_blocks", {0: torch.tensor([5], dtype=torch.int64),
                                                      1: torch.tensor([7], dtype=torch.int64)})
    assert counters()["search.bitmask_blocks"] == COUNTS["search.bitmask_blocks"] + 12
    monkeypatch.setattr(bitmask_mod, "_card_blocks", {})
    assert counters()["search.bitmask_blocks"] == COUNTS["search.bitmask_blocks"]


def test_the_packed_route_keeps_its_bits_and_counts_no_blocks(tmp_path, monkeypatch):
    """K3's plain version on the scene, routed there by giving K2 no words:
    the closest hits of the brute scan on every live lane, with no pairs in
    ``search.bitmask_blocks``; the same rays on K2 count their pairs."""
    _, load = _load(5, tmp_path)
    sc = load.scene
    gen = np.random.default_rng(5)
    r = 1000
    o = torch.from_numpy(gen.uniform(-80, 80, (r, 3)).astype(np.float32))
    d = torch.from_numpy(gen.normal(size=(r, 3)).astype(np.float32))
    d = torch.where((torch.arange(r) % 2 == 0)[:, None], -o, d)  # half aim at the center
    alive = torch.from_numpy(gen.random(r) > 0.3)
    tri = pack_triangles(sc.triangles, sc.n_triangles)
    want_d, want_i = search_brute_reference(o, d, tri, sc.n_triangles, alive)
    got = {}
    for words in ("0", "8"):
        monkeypatch.setenv("RTC_BITMASK_MAX_WORDS", words)
        way = search.route(sc.n_triangles, sc.accel.n_blocks, search.Knobs.read())
        before = counters()
        dst, idx = search.search_triangles(o, d, sc.triangles, sc.n_triangles, alive,
                                           accel=sc.accel)
        after = counters()
        got[way.tpu] = after["search.bitmask_blocks"] - before["search.bitmask_blocks"]
        assert after["search.cull_packets"] - before["search.cull_packets"] == r // 8
        assert torch.equal(idx[alive], want_i[alive])
        assert torch.equal(dst[alive].view(torch.int32), want_d[alive].view(torch.int32))
        assert int((idx[alive] >= 0).sum()) > r // 10
    assert got["K3"] == 0 < got["K2"]


def test_the_cell_is_in_the_benchmark_as_stated():
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    cell = spec.load_cell(CELL)
    assert cell.config["triangles"] == 16384 == parse_triangles_txt(SCENE)[0].shape[0]
    assert cell.config["reduced"] == [] and cell.chips == 1
    rays = next(m for m in bench["end_to_end"] if m["name"] == "rays_per_s")
    assert CELL in rays["workloads"]
    assert {m.name for m in cell.per_layer} == {"k2_bound_pct.tetra",
                                                "cull_blocks_per_packet.tetra"}
