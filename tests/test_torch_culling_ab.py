"""Port parity: the culling preludes of the range and words kernels.

``packet_block_ranges`` (the per-packet hitting-block span of K4/K5) and
``packet_tile_words`` (the one word per (packet, tile) of K6/K7) are integer
results of the same slab tests in both packages, so they must be EQUAL to
the JAX functions bit for bit: on a soup of more than 64 blocks whose count
is not a multiple of 64 (the JAX range prelude scans groups of 64), on
box_scene tessellated, on the trivial accel, with all-dead packets and a
ragged ray count.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu.ops.accel import trivial_accel as j_trivial_accel
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch.ops import culling
from raytracingc_tpu_torch.ops.accel import build_accel, trivial_accel
from test_torch_accel import port_tris, rays, soup

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")


def _scene(case):
    """``(JAX accel, port accel)`` of one test scene."""
    if case == "soup71":
        jtris, n = soup(9000, seed=31)  # 9,088 padded: 71 blocks
    elif case == "box_x5":
        js = jb.scene_from_triangles_txt(BOX_SCENE, use_native=False)
        jtris, n = jb.tessellate(js.triangles, js.n_triangles, levels=5)
    else:
        jtris, n = soup(700, seed=32)
        return j_trivial_accel(jtris), trivial_accel(port_tris(jtris))
    return j_build_accel(jtris, n), build_accel(port_tris(jtris), n)


def _packets(r, seed, dead_packets):
    """Ragged rays; 30% dead lanes, and every 5th packet wholly dead:
    ``((o, d, alive) for the port, their packets for JAX)``."""
    o, d, alive = rays(r, seed)
    if dead_packets:
        alive[(np.arange(r) // 8) % 5 == 0] = False
    ray = tuple(map(torch.from_numpy, (o, d, alive)))
    return ray, tuple(jnp.asarray(x.numpy()) for x in culling.packets(*ray))


@pytest.mark.parametrize("dead_packets", [False, True])
@pytest.mark.parametrize("case", ["soup71", "box_x5", "trivial"])
def test_packet_block_ranges_match_jax(case, dead_packets, monkeypatch):
    ja, pa = _scene(case)
    ray, jp = _packets(1001, seed=33, dead_packets=dead_packets)
    want = [np.asarray(x) for x in ip.packet_block_ranges(*jp, ja)]
    got = culling.packet_block_ranges(*ray, pa)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # One block per slab-test group: the grouping changes no bit.
    monkeypatch.setattr(culling, "SLAB_ELEMS_BUDGET", 1)
    one_by_one = culling.packet_block_ranges(*ray, pa)
    assert all(torch.equal(a, b) for a, b in zip(one_by_one, got))
    first, last = got
    empty = first > last
    # Empty spans are exactly (2**30, -1), and only packets without a live
    # lane that passes some box have one.
    assert (first[empty] == 2**30).all() and (last[empty] == -1).all()
    live = culling.packets(*ray)[2].any(dim=1)
    assert empty[~live].all()
    assert (first[~empty] >= 0).all() and (last[~empty] < pa.n_blocks).all()
    if case == "trivial":  # every box always passes: the whole plane
        assert (first[live] == 0).all() and (last[live] == pa.n_blocks - 1).all()
    else:
        assert (~empty).sum() > 20 and ((last - first)[~empty] > 0).any()
    if dead_packets:
        assert empty[::5].all()


@pytest.mark.parametrize("case,n_tiles", [("soup71", 1), ("soup71", 2),
                                          ("box_x5", 3), ("trivial", 1)])
def test_packet_tile_words_match_jax(case, n_tiles):
    ja, pa = _scene(case)
    bpt = -(-pa.n_blocks // n_tiles)
    granule = -(-bpt // culling.BITS_PER_WORD)
    ray, jp = _packets(999, seed=34, dead_packets=True)
    want = np.asarray(ip.packet_tile_words(*jp, ja, n_tiles, bpt, granule))
    got = culling.packet_tile_words(*ray, pa, n_tiles, bpt, granule)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # The one-word case of the packed kernel's words; the bits past the
    # tile's last granule stay clear.
    multi = culling.packet_tile_words_multi(*ray, pa, n_tiles, bpt, granule)
    assert multi.shape[2] == 1 and torch.equal(multi[..., 0], got)
    assert (want < 2 ** -(-bpt // granule)).all()
    assert (want[::5] == 0).all() and (want != 0).sum() > 20


def test_packet_tile_words_rejects_a_fine_granule():
    _, pa = _scene("soup71")
    ray, _ = _packets(16, seed=35, dead_packets=False)
    with pytest.raises(ValueError, match="granule=2"):
        culling.packet_tile_words(*ray, pa, 1, 71, 2)  # 36 bits
