"""Port parity: the two measurement tools' kernels, union walk (K9) and
shared-memory probe (K10), and the tools themselves on the CPU.

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.ops.accel import build_accel as j_build_accel
from raytracingc_tpu_torch import bridge
from raytracingc_tpu_torch.ops import culling, search
from raytracingc_tpu_torch.ops.search_bitmask import bitmask_table
from raytracingc_tpu_torch.ops.search_union import (
    search_union,
    search_union_reference,
    union_table,
)
from raytracingc_tpu_torch.scene.types import MISS_DST
from raytracingc_tpu_torch.tools import smem_probe, union_walk_ab
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
    words, flags = culling.program_union_words(*culling.packets(to, td, ta), pa)
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
    own = culling.packet_block_masks(*culling.packets(to, td, ta), pa)
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
