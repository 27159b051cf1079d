"""Port parity: the two measurement tools' kernels, union walk (K9) and
shared-memory probe (K10), and the tools themselves on the CPU; the parts
of the card-only tools (the packet sweep, the chunk profile) that run
without a card.

The JAX tools (``tools/union_walk_ab.py``, ``tools/smem_probe.py``) launch
their Pallas kernels without an ``interpret`` argument; the tests run them
in interpret mode by handing each tool module a ``pl`` whose
``pallas_call`` interprets, so the tools' files stay as they are.

K9's plain version (``ops/search_union.py``) must give the winners of the
JAX production search and of the JAX tool's union walk on every lane (dead
lanes masked) and their distances to rtol 1e-6 with atol 1e-5 (XLA:CPU
contracts multiply-adds into FMA and the port does not, ROADMAP Queue 3
P1); against the port's own default route it is equal bit for bit on live
lanes. K10's plain version equals the JAX probe bit for bit.
"""

import contextlib
import functools
import importlib.util
import io
import os
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.ops import _build, culling, search
from raytracingc_tpu_torch.ops.search_bitmask import (
    bitmask_table,
    search_bitmask_reference,
)
from raytracingc_tpu_torch.ops.search_brute import pack_triangles, search_brute_reference
from raytracingc_tpu_torch.ops.search_packed import search_packed_reference
from raytracingc_tpu_torch.ops.search_union import (
    search_union,
    search_union_reference,
    union_table,
)
from raytracingc_tpu_torch.scene.types import MISS_DST
from raytracingc_tpu_torch.tools import (
    chunk_profile,
    packet_sweep,
    packets,
    smem_probe,
    union_walk_ab,
)
from test_torch_accel import port_tris, soup
from test_torch_search_packet import KNOBS, rays_at

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _jax_tool(name, monkeypatch):
    """Import ``tools/<name>.py`` with its Pallas calls in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when))
    return mod


def test_union_walk_matches_jax(monkeypatch):
    jtris, n = soup(500, seed=21)  # 512 padded = 4 blocks
    ja = j_build_accel(jtris, n)
    o, d, alive = rays_at(1500, seed=22)  # 2 programs, the last one ragged
    jo, jd_, ja_ = jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive)
    tool = _jax_tool("union_walk_ab", monkeypatch)
    at = ja.triangles
    tri_flat = jnp.concatenate([at.a, at.b - at.a, at.c - at.a, at.normal],
                               axis=1).reshape(-1)
    ud, ui = (np.asarray(x) for x in tool.union_search(
        jo, jd_, ja_, ja, tri_flat, ja.orig_idx.astype(jnp.int32)))
    pd, pi = (np.asarray(x) for x in ip.search_triangles_pallas(
        jo, jd_, jtris, interpret=True, alive=ja_, accel=ja, n_live=n,
        variant="packet"))

    pa = bridge.accel_from_numpy(bridge.accel_arrays(ja))
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    words, flags = culling.program_union_words(to, td, ta, pa)
    args = (to, td, words, flags, pa.packed_plane, pa.orig_idx)
    kd, ki = search_union(*args)  # the CPU path is the plain version
    assert all(torch.equal(a, b) for a, b in zip((kd, ki), search_union_reference(*args)))
    kd = torch.where(ta, kd, MISS_DST).numpy()
    ki = torch.where(ta, ki, -1).numpy()
    for want_d, want_i in ((ud, ui), (pd, pi)):
        np.testing.assert_array_equal(ki[alive], want_i[alive])
        np.testing.assert_allclose(kd[alive], want_d[alive], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(ki, ui)  # the tool masks dead lanes too
    # The port's default route (bitmask), bit for bit on live lanes.
    rd, ri = search.search_triangles(to, td, port_tris(jtris), n, alive=ta, accel=pa)
    assert torch.equal(torch.from_numpy(ki)[ta], ri[ta])
    assert torch.equal(torch.from_numpy(kd)[ta].view(torch.int32), rd[ta].view(torch.int32))
    assert (ki[alive] >= 0).sum() > 100
    # Each packet tests its program's union, a superset of its own bits.
    table = union_table(words, flags, 1500, pa.n_blocks)
    own = culling.packet_block_masks(to, td, ta, pa)
    assert table.shape == (188, 4)
    assert torch.equal(table | bitmask_table(own, pa.n_blocks), table)


@pytest.mark.parametrize("n", [8, 1000, 58112])
def test_smem_probe_matches_jax(n, monkeypatch):
    tool = _jax_tool("smem_probe", monkeypatch)
    rs = np.random.default_rng(n)
    sm = rs.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    sm[n // 2] = 2**31 - 1  # the int32 sums wrap
    x = rs.normal(size=(64, 128)).astype(np.float32)
    want = np.asarray(tool.probe(jnp.asarray(sm), jnp.asarray(x), n))
    got = smem_probe.smem_probe(torch.from_numpy(sm), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


STAGING_SIZES = sorted(set(smem_probe.ladder(smem_probe.H100_OPTIN_BYTES))
                       | {1, 2, 5, 6, 7, 8, 9, 10, 11, 1001, 58109, 58110, 58111})


REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n", STAGING_SIZES)
def test_smem_staging_split_covers_the_table(n):
    """K10's staging (csrc/smem_probe.cu): the bulk-copy body and the tail of
    plain loads cover [0, n) exactly, the body in 16-byte units within the
    mbarrier's tx-count, the tail with room for the 8-byte mbarrier, and
    the kernel's 32 KiB copies cover the body once."""
    body, tail = smem_probe.staging_split(n)
    assert body + tail == n and body >= 0 and body % 4 == 0
    assert body * 4 < 2**20  # mbarrier tx-count range
    if body:
        assert smem_probe.TAIL_MIN <= tail <= smem_probe.TAIL_MIN + 3
        assert (body * 4) % 8 == 0  # the mbarrier's slot is 8-byte aligned
    else:
        assert n < 4 + smem_probe.TAIL_MIN and tail == n
    covered = np.zeros(n, np.int32)
    for off in range(0, body * 4, 32768):
        covered[off // 4:min(off + 32768, body * 4) // 4] += 1
    covered[body:] += 1
    assert (covered == 1).all()


def test_smem_staging_constants_match_the_source():
    src = (REPO / "raytracingc_tpu_torch" / "csrc" / "smem_probe.cu").read_text()
    assert f"constexpr int kTailMin = {smem_probe.TAIL_MIN};" in src
    assert "constexpr uint32_t kChunkBytes = 32768;" in src
    assert "return n >= 4 + kTailMin ? (n - kTailMin) / 4 * 4 : 0;" in src


def test_wrappers_validate():
    o = torch.zeros((16, 3))
    d = torch.ones((16, 3))
    plane = torch.zeros((12, 128))
    oi = torch.zeros((128,), dtype=torch.int32)
    w = torch.zeros((1, 1), dtype=torch.int32)
    f = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="words"):
        search_union(o, d, w.repeat(2, 1), f, plane, oi)
    with pytest.raises(ValueError, match="flags"):
        search_union(o, d, w, f.float(), plane, oi)
    with pytest.raises(RuntimeError, match="no kernel"):
        search_union(*(x.to("meta") for x in (o, d, w, f, plane, oi)))
    dst, idx = search_union(o, d, w, f, plane, oi)  # a dead program misses
    assert (idx == -1).all() and (dst == MISS_DST).all()
    x = torch.ones(smem_probe.X_SHAPE)
    with pytest.raises(ValueError, match="sm"):
        smem_probe.smem_probe(torch.arange(7, dtype=torch.int32), x)
    with pytest.raises(ValueError, match="x"):
        smem_probe.smem_probe(torch.arange(8, dtype=torch.int32), x[:60])
    with pytest.raises(RuntimeError, match="no kernel"):
        smem_probe.smem_probe(torch.arange(8, dtype=torch.int32).to("meta"),
                              x.to("meta"))
    assert smem_probe.ladder(smem_probe.H100_OPTIN_BYTES) == [
        12288, 16384, 32768, 49152, 57344, 58112, 58113, 65536]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_union_walk_tool_on_cpu():
    rc, out = _run(union_walk_ab.main, ["--device", "cpu", "--tessellate", "3",
                                        "-s", "48", "32", "--rays", "1024"])
    assert rc == 0, out
    assert "box_scene.txt tessellated 3 levels, 640 triangles" in out
    for name in ("front", "center", "secondary"):
        assert f"== {name}: 1024 rays" in out
    assert out.count("dst True idx True") == 3
    assert "K9 union not measured" in out


def test_smem_probe_tool_on_cpu():
    rc, out = _run(smem_probe.main, ["--device", "cpu"])
    assert rc == 0, out
    assert "opt-in maximum: 232448 bytes" in out
    assert out.count(": OK") == 8 and "FAIL" not in out


def test_packet_sweep_ray_sets():
    """Both ray sets share an origin region per packet; the secondary set's
    lanes point apart, the coherent set's together; DEAD of lanes dead."""
    for make, coherent in ((packets.packet_rays, True),
                           (packets.secondary_rays, False)):
        o, d, alive = make(np.random.default_rng(3), 8003, *packet_sweep.BOX_ORIGINS)
        assert o.shape == d.shape == (8003, 3) and o.dtype == d.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-6)
        assert abs(alive.mean() - (1 - packets.DEAD)) < 0.03
        spread = lambda x: np.abs(x[:8000].reshape(-1, 8, 3) - x[:8000:8, None]).max(1)
        assert np.median(spread(o)) < 0.2
        assert (np.median(spread(d)) < 0.2) == coherent


def test_packet_inputs_follow_the_dispatch(monkeypatch):
    """The packet-route inputs the tools build: the auto route's kernel, and
    the plain K2 and K3 on them equal the brute scan on live lanes."""
    scene = union_walk_ab.load_scene(union_walk_ab.BOX_SCENE, 4, "cpu")  # 2,560
    o, d, alive = (torch.from_numpy(x) for x in packets.secondary_rays(
        np.random.default_rng(4), 1024, *packet_sweep.BOX_ORIGINS))
    bd, bi = search_brute_reference(
        o, d, pack_triangles(scene.triangles, scene.n_triangles),
        scene.n_triangles, alive)
    for env, kernel in (({}, "bitmask"), ({"RTC_STREAM_MAX_T": "1024",
                                           "RTC_STREAM_TILE": "768"}, "packed")):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            way, words, plane, oi = packets.packet_inputs(scene, o, d, alive)
        assert way.kernel == kernel
        if kernel == "bitmask":
            got_d, got_i = search_bitmask_reference(o, d, words, plane, oi)
        else:
            assert way.n_tiles > 1
            got_d, got_i = search_packed_reference(o, d, words, plane, oi,
                                                   way.tile, way.granule)
        assert torch.equal(got_i[alive], bi[alive])
        assert torch.equal(got_d[alive].view(torch.int32), bd[alive].view(torch.int32))
        assert (got_i[alive] >= 0).sum() > 300


@pytest.mark.parametrize("levels", [3, "soup 1024"])
def test_packet_sweep_program_calls(levels):
    """packet_sweep's program-union cases on the CPU (the plain versions):
    K8 in both precisions on its scenes' kinds, and K9, each call equal to
    its plain call; the digest tells results apart."""
    rng = np.random.default_rng(8)
    scene = packet_sweep.load(levels, "cpu", rng)
    origins = packet_sweep.BOX_ORIGINS if levels == 3 else packets.SOUP_ORIGINS
    o, d, alive = (torch.from_numpy(x) for x in packets.packet_rays(rng, 1100, *origins))
    digests = set()
    for union in (False, True):
        calls, pairs = packet_sweep.program_calls(scene, o, d, alive, union)
        assert sorted(calls) == (["K9 union"] if union else ["K8 highest", "K8 split3"])
        assert pairs > 0 and pairs % (1024 * 128) == 0
        for kernel, plain in calls.values():
            (kd, ki), (pd, pi) = kernel(), plain()
            assert torch.equal(ki, pi) and torch.equal(kd, pd)
            assert (ki[alive] >= 0).sum() > 100
            digests.add(packet_sweep.digest(kd, ki))
    assert len(digests) == 3  # the two precisions and K9 differ somewhere


def test_chunk_profile_busy_union():
    assert chunk_profile.busy_us([]) == 0.0
    assert chunk_profile.busy_us([(5, 6), (0, 2), (1, 3), (5.5, 5.75)]) == 4.0


def test_card_only_tools_refuse_the_cpu():
    for tool in (packet_sweep, chunk_profile):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])


def test_ptxas_report():
    """The ptxas report names each entry function's registers and spills."""
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "search_bitmask_kernelEPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_121search_bitmask_kernelEPKf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, 412 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
        "search_packed_kernelEPKf' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 412 bytes cmem[0]\n")
    assert _build.ptxas_report("search_bitmask_kernel", log) == (
        "96 registers, 0 bytes spill stores, 0 bytes spill loads")
    assert _build.ptxas_report("search_packed_kernel", log) == (
        "128 registers, 4 bytes spill stores, 8 bytes spill loads")
    assert _build.ptxas_report("search_range_kernel", log) == ""
