"""The ``spd_tetra.frame1080`` cell on the CPU at a tiny size: correct as it
stands, not correct with K2's inputs broken underneath, and its two
per-layer readers' arithmetic on a synthetic span and counter snapshot."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny
from portbench import run
from portbench.lib import spec
from portbench.lib.trace import Span

CPU = torch.device("cpu")
SEED = 2**31 + 1234567
CELL = "spd_tetra.frame1080"


def _run():
    result, _ = run.run_cell(tiny(spec.load_cell(CELL)), SEED, 0.0, False, CPU)
    return result


def test_the_tiny_cell_is_correct_on_the_cpu():
    result = _run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"mismatch_share", "ray_count_gap"}
    assert result["checks"]["mismatch_share"]["value"] == 0.0
    assert result["checks"]["ray_count_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"rays_per_s", "setup_s"}


def _drop_a_block_bit(monkeypatch):
    """Each packet loses the lowest set bit of its first nonzero word: one
    block it should have walked."""
    from raytracingc_tpu_torch.ops import culling

    real = culling.packet_block_masks

    def masks(o_p, d_p, a_p, accel):
        words = real(o_p, d_p, a_p, accel).clone()
        rows = torch.arange(words.shape[0])
        first = (words != 0).int().argmax(1)
        w = words[rows, first]
        words[rows, first] = w & (w - 1)
        return words

    monkeypatch.setattr(culling, "packet_block_masks", masks)


def _half_rays(monkeypatch):
    """K2 searches the rays rounded to float16. (A float16 plane is no fault
    on this scene: its vertices are integers of at most 64, exact in
    float16, so only the normals round, which decide back faces alone.)"""
    from raytracingc_tpu_torch.ops import search

    real = search.search_bitmask

    def search_bitmask(o, d, words, plane, orig_idx):
        return real(o.half().float(), d.half().float(), words, plane, orig_idx)

    monkeypatch.setattr(search, "search_bitmask", search_bitmask)


@pytest.mark.parametrize("fault", [_drop_a_block_bit, _half_rays])
def test_a_broken_search_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def _span(search_s=0.01, rays=1_000_000):
    return Span(window_s=1.0, busy_s=0.5, kernels=100, search_s=search_s, device_ops=[],
                idle_gaps=[], work={"rays": rays, "frames": 1})


COUNTS = {"search.bitmask_blocks": 2_000_000, "integrator.lanes": 8_000_000,
          "search.cull_packets": 400_000}


def _reader(name):
    return spec._reader("metrics", name)


def test_k2_bound_pct_reads_the_span_pairs_over_the_search_time():
    # 2e6 / 8e6 pairs a ray x 1e6 rays = 250,000 pairs of 8 x 128 x 61
    # operations at 33.4e12/s: 0.46754 ms of a 10 ms search.
    got = _reader("k2_bound_pct.tetra")(_span(), COUNTS)
    assert got == pytest.approx(100 * 250_000 * 8 * 128 * 61 / 33.4e12 / 0.01, rel=1e-12)
    assert got == pytest.approx(4.6754, rel=1e-4)


def test_cull_blocks_per_packet_reads_blocks_over_packets():
    assert _reader("cull_blocks_per_packet.tetra")(_span(), COUNTS) == 5.0


@pytest.mark.parametrize("missing", ["search.bitmask_blocks", "integrator.lanes",
                                     "search.cull_packets"])
def test_the_readers_read_nothing_without_the_counters(missing):
    counts = {k: v for k, v in COUNTS.items() if k != missing}
    k2, cull = _reader("k2_bound_pct.tetra"), _reader("cull_blocks_per_packet.tetra")
    values = (k2(_span(), counts), cull(_span(), counts))
    if missing == "search.cull_packets":
        assert values[0] is not None and values[1] is None
    else:
        assert values[0] is None
        assert (values[1] is None) == (missing == "search.bitmask_blocks")
    zero = dict(COUNTS, **{"search.bitmask_blocks": 0})
    assert k2(_span(), zero) is None and cull(_span(), zero) is None


def test_k2_bound_pct_reads_nothing_without_search_time_or_rays():
    k2 = _reader("k2_bound_pct.tetra")
    assert k2(None, COUNTS) is None
    assert k2(_span(search_s=0.0), COUNTS) is None
    assert k2(_span(rays=0), COUNTS) is None


def test_the_readers_take_the_programs_counters_by_default(monkeypatch):
    from raytracingc_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTS))
    assert _reader("cull_blocks_per_packet.tetra")(_span()) == 5.0
    assert _reader("k2_bound_pct.tetra")(_span()) == pytest.approx(4.6754, rel=1e-4)
    monkeypatch.setattr(profiling, "counters", lambda: {"integrator.lanes": 1})
    assert _reader("cull_blocks_per_packet.tetra")(_span()) is None
    assert _reader("k2_bound_pct.tetra")(_span()) is None
