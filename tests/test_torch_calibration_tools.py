"""The port's dispatch-calibration and granule tools on the CPU.

``tools/dispatch_calibration.py``: both legs (``RTC_BRUTE_MAX`` 10,000,000
and 0) in one process give the same BMP bytes and traced rays, and each
leg's search takes the route it names (K1, K2). ``tools/granule_analysis.py``:
its counts on box_scene --tessellate 5 with a tile of 4,096 triangles (3
tiles, 32 blocks a tile, granules 2 and 1) equal, as integers, the JAX tool's
arithmetic (``tools/granule_analysis.py``'s ``scanned_for`` and its
active-column count) recomputed here from ``intersect_pallas._slab_any_hit``
and ``packet_tile_words`` on the same rays.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.camera import Camera as JCamera
from raytracingc_tpu.camera import primary_rays as j_primary_rays
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch.ops import search
from raytracingc_tpu_torch.tools import dispatch_calibration, granule_analysis
from raytracingc_tpu_torch.tools.union_walk_ab import load_scene
from test_torch_search_packet import KNOBS

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
LEVEL, TILE = 5, 4096  # 10,240 triangles, 80 blocks: 3 tiles of 32 blocks


@pytest.fixture(autouse=True)
def _one_torch_thread_clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dispatch_legs_equal_bits_counts_and_routes(monkeypatch):
    """box_scene --tessellate 3 at 16x16, spp 2, 2 bounces: the brute and
    packet legs write the same BMP bytes and trace the same rays; brute
    routes to K1, packet to the bitmask kernel K2."""
    monkeypatch.setattr(dispatch_calibration, "MAX_BOUNCE", 2)
    launched = []
    rows = dispatch_calibration.calibrate(
        torch.device("cpu"), grid=((3, 16, 16, 2),), reps=1,
        on_cell=lambda r: launched.append((r["leg"], os.environ.get("RTC_BRUTE_MAX"))))
    brute, packet = rows
    assert (brute["leg"], packet["leg"]) == ("brute", "packet")
    assert brute["n_live"] == packet["n_live"] == 640
    assert brute["route"] == search.Route("brute", "K1")
    assert packet["route"] == search.Route("bitmask", "K2")
    assert brute["bmp"] == packet["bmp"] and brute["bmp"][:2] == b"BM"
    assert brute["rays"] == packet["rays"] > 256
    assert brute["rays_per_s"] > 0 and packet["rays_per_s"] > 0
    assert launched == [("brute", None), ("packet", None)]  # knobs restored


def test_crossover_reads_the_grid():
    row = lambda leg, n, s, w=1920: dict(leg=leg, n_live=n, seconds=s, width=w,
                                        height=1080)
    rows = [row("brute", 2560, 1.0), row("packet", 2560, 2.0),
            row("brute", 10240, 3.0), row("packet", 10240, 2.0),
            row("brute", 640, 1.0, 128), row("packet", 640, 1.0, 128)]
    assert dispatch_calibration.crossover(rows) == {
        "128x1080": {"brute_up_to": 640, "packet_from": None},
        "1920x1080": {"brute_up_to": 2560, "packet_from": 10240}}


def test_dispatch_calibration_main_on_cpu(monkeypatch):
    """The entry point on the CPU with a one-cell grid: a line per leg and
    the JSON object last."""
    monkeypatch.setattr(dispatch_calibration, "GRID", ((3, 8, 8, 1),))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dispatch_calibration.main(["--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[1].startswith("brute level=3 tris=640 8x8 spp=1")
    assert lines[2].startswith("packet level=3 tris=640 8x8 spp=1")
    out = json.loads(lines[-1])
    assert [c["route"]["tpu"] for c in out["cells"]] == ["K1", "K2"]
    assert out["cells"][0]["bmp_sha256"] == out["cells"][1]["bmp_sha256"]


def _jax_counts(accel, o, d, tile, granules, chunk):
    """The JAX tool's arithmetic: per granule the run lengths of the set
    union-box bits (its ``scanned_for``), and the active columns of the
    route's words, summed over chunks."""
    t = accel.triangles.a.shape[0]
    n_blocks = accel.aabb_lo.shape[0]
    tile = min(tile, t)
    bpt = tile // ip.TRI_LANES
    n_tiles = -(-t // tile)
    granule = -(-bpt // ip.BITS_PER_WORD)
    big = jnp.float32(3.0e38)

    def scanned_for(o_p, d_p, a_p, g):
        inv_p = 1.0 / jnp.where(jnp.abs(d_p) < 1e-20, 1e-20, d_p)
        bits = -(-bpt // g)
        total = n_tiles * bits * g
        lo = jnp.pad(accel.aabb_lo, ((0, total - n_blocks), (0, 0)),
                     constant_values=big).reshape(n_tiles * bits, g, 3)
        hi = jnp.pad(accel.aabb_hi, ((0, total - n_blocks), (0, 0)),
                     constant_values=-big).reshape(n_tiles * bits, g, 3)
        lo_g, hi_g = lo.min(axis=1), hi.max(axis=1)
        starts = (jnp.arange(n_tiles * bits, dtype=jnp.int32) % bits) * g
        run_len = jnp.minimum(starts + g, bpt) - starts
        n_groups, slab = n_tiles * bits, 64
        pad_g = -(-n_groups // slab) * slab - n_groups
        lo_g = jnp.pad(lo_g, ((0, pad_g), (0, 0)), constant_values=big)
        hi_g = jnp.pad(hi_g, ((0, pad_g), (0, 0)), constant_values=-big)
        rl = jnp.pad(run_len, (0, pad_g))

        def slab_fn(args):
            lo1, hi1, rl1 = args
            return jnp.sum(ip._slab_any_hit(lo1, hi1, o_p, inv_p, a_p) * rl1[None, :])

        return jnp.sum(jax.lax.map(slab_fn, (lo_g.reshape(-1, slab, 3),
                                             hi_g.reshape(-1, slab, 3),
                                             rl.reshape(-1, slab))))

    scanned = dict.fromkeys(granules, 0)
    active = pairs = 0
    for i in range(0, o.shape[0], chunk):
        c = o[i:i + chunk].shape[0] // 8
        o_p = o[i:i + chunk].reshape(c, 8, 3)
        d_p = d[i:i + chunk].reshape(c, 8, 3)
        a_p = jnp.ones((c, 8), bool)
        words = ip.packet_tile_words(o_p, d_p, a_p, accel, n_tiles, bpt, granule)
        active += int(jnp.sum(words != 0))
        pairs += words.shape[0] * words.shape[1]
        for g in granules:
            scanned[g] += int(scanned_for(o_p, d_p, a_p, g))
    return {"scanned": scanned, "active_cols": active, "pairs": pairs}


def test_granule_counts_equal_the_jax_tools_arithmetic():
    js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
    tris, n = jb.tessellate(js.triangles, js.n_triangles, levels=LEVEL)
    js = js.replace(triangles=tris, n_triangles=n, accel=None).with_accel()
    o, d = j_primary_rays(JCamera.look_at(), 96, 64)  # 6,144 rays
    scene = load_scene(BOX_SCENE, LEVEL, "cpu")
    tile, n_tiles, bpt = granule_analysis.layout(scene.accel, TILE)
    granules = granule_analysis.granules_for(bpt)
    assert (tile, n_tiles, bpt, granules) == (TILE, 3, 32, [2, 1])
    chunk = 2048  # several chunks, as the full frame's 65,536-ray chunks
    got = granule_analysis.granule_counts(
        scene.accel, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
        TILE, granules, chunk=chunk)
    want = _jax_counts(js.accel, o, d, TILE, granules, chunk)
    assert got == want
    assert got["scanned"][2] > got["scanned"][1] > 0
    assert 0 < got["active_cols"] < got["pairs"] == (6144 // 8) * 3
    lines = granule_analysis.report(got, bpt)
    assert lines[-1].startswith("active_col_frac=") and "vs_exact=1.000" in lines[1]


def test_granule_analysis_main_on_cpu():
    """The entry point on the CPU at level 3 (640 triangles, one tile of 5
    blocks, granule 1) over the whole 1920x1080 frame."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert granule_analysis.main(["--device", "cpu", "--tessellate", "3"]) == 0
    lines = buf.getvalue().splitlines()
    assert "tris=640 padded=640 blocks=5 tiles=1 bpt=5 granule=1" in lines[1]
    assert "over 32 chunks" in lines[2]
    out = json.loads(lines[-1])
    assert out["n_live"] == 640 and list(out["scanned"]) == ["1"]
    assert out["pairs"] == 1920 * 1080 // 8
