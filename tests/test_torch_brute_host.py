"""The brute-force search K1 (``ops/search_brute.py``, ``csrc/search_brute.cu``):
its host path and the kernel's split of a ray's scan, on the CPU.

- ``no_tangent``'s plain call: no ``autograd.Function`` in a plain forward,
  the Function under ``torch.func.jvp``, ``vmap``, ``forward_ad`` and with
  an input that requires grad; no derivative on the outputs in any case.
- ``Knobs.read`` parses once per set of raw values: a changed value is
  read, a typo raises on every call.
- The brute leg of ``search_triangles`` (the pack-free entry: the scene's
  ``Triangles``, no packing per call) gives the bits of the packed rows'
  plain scan, which the JAX package's brute kernel (interpret mode) gives
  too, on box_scene and on a seeded soup, with and without ``alive``.
- ``search_brute_split``, the plain model of the kernel's S lanes per ray
  (interleaved parts merged by a lex-min), equals the scan bit for bit at
  every S, ties across parts included; ``brute_parts`` and the model's
  constants are the source's.
- Production's K1 calls carry dead lanes once a frame: the last pixel
  chunk's primary search (its padding); the other primary searches pass
  an all-true ``alive``, the compacted bounces none.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

import raytracingc_tpu.ops.intersect_pallas as ip
from raytracingc_tpu.scene import builder as jb
from raytracingc_tpu_torch.camera import Camera
from raytracingc_tpu_torch.ops import _build, no_tangent, search
from raytracingc_tpu_torch.ops import search_brute as sb
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene.builder import scene_from_triangles_txt
from raytracingc_tpu_torch.scene.types import Triangles

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")


def _bits(x):
    return x.view(torch.int32)


def _soup(n_live, seed, n_rays=300):
    """``(Triangles, o, d, alive)``: triangles in front of rays near the
    origin looking down +z, every 3rd duplicating an earlier one (equal
    distances, across parts too), half the normals flipped; 30% dead."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-3, 3, size=(n_live, 3)).astype(np.float32)
    c[:, 2] += 6.0
    verts = np.stack([c, c + rs.normal(size=(n_live, 3)) * 1.5,
                      c + rs.normal(size=(n_live, 3)) * 1.5], axis=1).astype(np.float32)
    dup = np.arange(3, n_live, 3)
    verts[dup] = verts[dup // 3]
    normals = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    normals[::2] *= -1.0
    tris = Triangles.from_numpy(verts, normals, np.full((n_live, 3), 0.5),
                                np.zeros(n_live), np.zeros(n_live))
    o = (rs.normal(size=(n_rays, 3)) * 0.3).astype(np.float32)
    d = rs.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rs.uniform(size=n_rays) >= 0.3
    return tris, *(torch.from_numpy(x) for x in (o, d, alive))


@pytest.fixture
def applied(monkeypatch):
    """How often ``_NoTangent.apply`` ran."""
    calls = []
    real = no_tangent._NoTangent.apply

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(no_tangent._NoTangent, "apply", spy)
    return calls


def test_no_tangent_plain_call_applies_no_function(applied):
    tris, o, d, alive = _soup(40, seed=1)
    tri = sb.pack_triangles(tris, 40)
    want = sb.search_brute_reference(o, d, tri, 40, alive)
    for got in (sb.search_brute(o, d, tri, 40, alive), sb.search_brute(o, d, tris, 40, alive)):
        assert torch.equal(_bits(got[0]), _bits(want[0])) and torch.equal(got[1], want[1])
        assert not got[0].requires_grad and got[0].grad_fn is None
    with torch.no_grad():  # grad mode off: an input requiring grad needs no Function
        sb.search_brute(o.clone().requires_grad_(True), d, tri, 40)
    assert applied == []


@pytest.mark.parametrize("mode", ["jvp", "vmap", "forward_ad", "requires_grad"])
def test_no_tangent_applies_the_function_under_transforms(applied, mode):
    """Each mode applies the Function; the outputs are the plain call's
    bits and carry no derivative."""
    tris, o, d, alive = _soup(40, seed=2)
    want_d, want_i = sb.search_brute(o, d, tris, 40, alive)
    assert applied == [] and int((want_i >= 0).sum()) > 20
    if mode == "jvp":
        dst, tangent, idx = torch.func.jvp(
            lambda o_: (lambda r: (r[0], r[1]))(sb.search_brute(o_, d, tris, 40, alive)),
            (o,), (torch.ones_like(o),), has_aux=True)
        assert torch.equal(tangent, torch.zeros_like(tangent))
    elif mode == "vmap":
        dst, idx = torch.func.vmap(lambda o_: sb.search_brute(
            o_.contiguous(), d, tris, 40, alive))(torch.stack([o, o]))
        dst, idx = dst[1], idx[1]
    elif mode == "forward_ad":
        with fwAD.dual_level():
            out = sb.search_brute(fwAD.make_dual(o, torch.ones_like(o)), d, tris, 40, alive)
            assert fwAD.unpack_dual(out[0]).tangent is None
        dst, idx = out
    else:
        a = tris.a.clone().requires_grad_(True)
        dst, idx = sb.search_brute(o, d, dataclasses.replace(tris, a=a), 40, alive)
        assert not dst.requires_grad and dst.grad_fn is None
    assert applied
    assert torch.equal(_bits(dst), _bits(want_d)) and torch.equal(idx, want_i)


def test_knobs_parse_once_per_raw_values(monkeypatch):
    for name in search._KNOB_NAMES:
        monkeypatch.delenv(name, raising=False)
    first = search.Knobs.read()
    assert search.Knobs.read() is first  # the same raw values: no re-parse
    assert first.brute_max == search.BRUTE_MAX_TRIS
    monkeypatch.setenv("RTC_BRUTE_MAX", "7")
    assert search.Knobs.read().brute_max == 7
    monkeypatch.setenv("RTC_KERNEL", "brutte")
    for _ in range(2):  # a typo raises on the second call too
        with pytest.raises(ValueError, match="RTC_KERNEL"):
            search.Knobs.read()
    monkeypatch.setenv("RTC_KERNEL", "packet")
    assert search.Knobs.read() == dataclasses.replace(first, kernel="packet", brute_max=7)


@pytest.mark.parametrize("name", [
    "RTC_KERNEL", "RTC_MXU_PRECISION", "RTC_CULL", "RTC_STREAM_CULL", "RTC_STREAM_ORDER",
    "RTC_EXTRACT", "RTC_COL_GROUP", "RTC_STREAM_GRANULE", "RTC_BRUTE_MAX",
    "RTC_BITMASK_MAX_WORDS", "RTC_STREAM_MAX_T", "RTC_STREAM_TILE"])
def test_every_knob_is_watched(monkeypatch, name):
    """A bad value of any knob raises after a good parse was kept, on every
    route: the cache watches every variable the parse reads."""
    search.Knobs.read()
    monkeypatch.setenv(name, "-1x")
    with pytest.raises(ValueError, match=name):
        search.Knobs.read()
    tris, o, d, _ = _soup(20, seed=3)
    with pytest.raises(ValueError, match=name):
        search.search_triangles(o, d, tris, 20)


def test_knob_parse_reads_only_watched_names(monkeypatch):
    seen = set()

    class Recording(dict):
        def get(self, key, default=None):
            seen.add(key)
            return super().get(key, default)

    monkeypatch.setattr(os, "environ", Recording(os.environ))
    search.Knobs._parse()
    assert seen and seen <= set(search._KNOB_NAMES)


def _jax_brute(tris, n, o, d, alive):
    jtris = jb.triangles_from_arrays(
        np.stack([tris.a.numpy(), tris.b.numpy(), tris.c.numpy()], axis=1),
        tris.normal.numpy(), tris.albedo.numpy(), tris.emission.numpy(),
        tris.smoothness.numpy())[0]
    ja = None if alive is None else jnp.asarray(alive.numpy())
    jd, ji = ip.search_triangles_pallas(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                        jtris, interpret=True, n_live=n, alive=ja)
    return np.asarray(jd), np.asarray(ji)


@pytest.mark.parametrize("scene", ["box", "soup"])
@pytest.mark.parametrize("with_alive", [False, True])
def test_brute_leg_gives_the_packed_scan_bits(scene, with_alive, monkeypatch):
    """search_triangles' brute leg (the pack-free entry, no accel built)
    == the packed rows' plain scan bit for bit (the leg before the change),
    and the JAX brute kernel's winners; misses and dead lanes (MISS_DST,
    -1)."""
    monkeypatch.delenv("RTC_KERNEL", raising=False)
    if scene == "box":
        s = scene_from_triangles_txt(BOX_SCENE)
        tris, n = s.triangles, s.n_triangles
        _, o, d, alive = _soup(10, seed=4, n_rays=400)
        o = o + torch.tensor([0.0, 1.0, -2.0])
    else:
        tris, o, d, alive = _soup(300, seed=5)
        n = 300
    al = alive if with_alive else None
    built = []
    monkeypatch.setattr(search, "trivial_accel", lambda t: built.append(1))
    got_d, got_i = search.search_triangles(o, d, tris, n, alive=al)
    assert built == []
    want_d, want_i = sb.search_brute_reference(o, d, sb.pack_triangles(tris, n), n, al)
    assert torch.equal(_bits(got_d), _bits(want_d)) and torch.equal(got_i, want_i)
    jd, ji = _jax_brute(tris, n, o, d, al)
    np.testing.assert_array_equal(got_i.numpy(), ji)
    np.testing.assert_allclose(got_d.numpy(), jd, rtol=1e-6, atol=1e-5)
    assert int((got_i >= 0).sum()) > 50 and int((got_i < 0).sum()) > 0
    if with_alive:
        assert (got_i[~alive] == -1).all() and (got_d[~alive] == 999999.0).all()


def test_pack_free_entry_equals_packed_rows():
    """search_brute on Triangles (the kernel reads a, b, c, normal and
    forms AB, AC itself) == search_brute on pack_triangles' rows, for views
    that are not contiguous too, and checks its inputs as the packed entry
    does."""
    tris, o, d, alive = _soup(64, seed=6)
    for n in (0, 1, 17, 64):
        for al in (None, alive):
            want = sb.search_brute(o, d, sb.pack_triangles(tris, n), n, al)
            got = sb.search_brute(o, d, tris, n, al)
            assert torch.equal(_bits(got[0]), _bits(want[0])) and torch.equal(got[1], want[1])
    strided = dataclasses.replace(tris, a=torch.cat([tris.a, tris.b], 1)[:, :3])
    assert not strided.a.is_contiguous()
    got = sb.search_brute(o, d, strided, 64)
    assert torch.equal(got[1], sb.search_brute(o, d, tris, 64)[1])
    with pytest.raises(ValueError, match="n_live"):
        sb.search_brute(o, d, tris, 65)
    with pytest.raises(ValueError, match="normal"):
        sb.search_brute(o, d, dataclasses.replace(tris, normal=tris.normal.double()), 64)
    with pytest.raises(ValueError, match="alive"):
        sb.search_brute(o, d, tris, 64, alive[:5])
    with pytest.raises(RuntimeError, match="no kernel"):
        meta = Triangles(**{f.name: getattr(tris, f.name).to("meta")
                            for f in dataclasses.fields(tris)})
        sb.search_brute(o.to("meta"), d.to("meta"), meta, 64)


@pytest.mark.parametrize("parts", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_live", [1, 5, 37, 300])
def test_split_scan_equals_the_scan(parts, n_live):
    """S interleaved parts, each an ascending strict-< scan, merged by a
    lex-min on (dst, idx): the scan's bits, equal distances across parts
    resolved to the lowest index. n_live < S leaves parts empty."""
    tris, o, d, alive = _soup(n_live, seed=7 + n_live)
    tri = sb.pack_triangles(tris, n_live)
    for al in (None, alive):
        want = sb.search_brute_reference(o, d, tri, n_live, al)
        got = sb.search_brute_split(o, d, tri, n_live, al, parts=parts)
        assert torch.equal(_bits(got[0]), _bits(want[0])) and torch.equal(got[1], want[1])


def test_the_soup_has_ties_across_parts():
    """A merge that kept the HIGHEST index among equal distances would fail
    test_split_scan_equals_the_scan: the soup's duplicates put equal least
    distances into different parts."""
    tris, o, d, _ = _soup(300, seed=307)
    tri = sb.pack_triangles(tris, 300)
    ray = (o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3])
    dst = sb.mt_distance(ray, tri.T)
    least = dst.min(1, keepdim=True).values
    ties = (dst == least) & (least < 999999.0)
    idx = torch.arange(300)
    crossing = [(ties[r] & (idx % 4 != int(idx[ties[r]][0]) % 4)).any()
                for r in range(o.shape[0]) if int(ties[r].sum()) > 1]
    assert sum(bool(c) for c in crossing) >= 5


def test_brute_parts_and_constants_are_the_kernels():
    text = (_build.SRC_DIR / "search_brute.cu").read_text()
    for name, value in (("kMaxParts", sb.MAX_PARTS), ("kMinPartRows", sb.MIN_PART_ROWS),
                        ("kTileRows", sb.TILE_ROWS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == value
    a, b = re.search(r"constexpr int64_t kFillLanes = (\d+) \* (\d+);", text).groups()
    assert int(a) * int(b) == sb.FILL_LANES
    assert sb.brute_parts(65536, 640) == 8
    assert sb.brute_parts(16384, 640) == 16
    assert sb.brute_parts(65536, 10) == 1
    assert sb.brute_parts(1 << 19, 640) == 1
    assert sb.brute_parts(1, 257) == 16 and sb.brute_parts(1, 255) == 8
    assert sb.TILE_ROWS % sb.MAX_PARTS == 0  # a tile starts every part at its own rows


@pytest.mark.parametrize("mode", ["production", "oracle"])
def test_production_k1_calls_carry_dead_lanes_once_a_frame(monkeypatch, mode):
    """The production render (early exit, compaction) hands K1 dead lanes
    in one call a frame: the primary search of the last pixel chunk, whose
    padding is dead (render/renderer.py pad_rays). The other chunks' primary
    searches pass an all-true alive and the compacted bounces none. The
    masked oracle (compact=False, early_exit=False) passes dead lanes on
    every bounce."""
    scene = scene_from_triangles_txt(BOX_SCENE)
    cam = Camera.look_at(origin=[0.0, 1.0, -4.0], target=[0.0, 1.0, 0.0])
    kinds = []
    real = search.search_brute

    def spy(o, d, tri, n_live, alive=None):
        kinds.append("none" if alive is None else
                     "all" if bool(alive.all()) else "dead")
        return real(o, d, tri, n_live, alive)

    monkeypatch.setattr(search, "search_brute", spy)
    kw = {} if mode == "production" else dict(early_exit=False, compact=False)
    render(scene, cam, 12, 10, 2, 3, seed=1, pixel_chunk=32, **kw)  # 120 of 128 lanes
    if mode == "production":
        assert kinds.count("dead") == 1 and kinds.count("all") == 3
        assert kinds.count("none") == len(kinds) - 4 > 0
    else:
        assert kinds.count("dead") > 4


def test_packet_sweep_brute_cases_hold_the_plain_scan(monkeypatch, capsys):
    """packet_sweep's K1 cases (packed entry and dispatch leg, both ray
    sets, dead lanes and all live, R and R / 4) agree with the plain scan;
    on the CPU with the timing stubbed."""
    from raytracingc_tpu_torch.tools import packet_sweep

    timed = []
    monkeypatch.setattr(packet_sweep, "split_times", lambda call, kernel: (
        timed.append(call()), {"ms": 0.0, "host": 0.0, "profiler": 0.0})[1])
    scene = packet_sweep.load(1, torch.device("cpu"), None)  # 40 triangles
    packet_sweep.time_brute("K1 box 40", scene, np.random.default_rng(3), 64,
                            torch.device("cpu"), packet_sweep.BOX_ORIGINS)
    assert len(timed) == 2 * 2 * 2 * 2
    assert capsys.readouterr().out.count("[wrappers] K1 box 40") == 16


# A listing in cuobjdump's form: a loop (0x0040-0x0120) whose MT test skips
# the reciprocal's slow-path call (0x0090-0x00a0) on the fast path.
_SASS = """
        Function : _Z19search_brute_kernelILi8ELb0EEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;    /* 0x0 */
        /*0010*/                   S2R R0, SR_TID.X ;    /* 0x0 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x1, PT ;    /* 0x0 */
        /*0030*/               @P0 EXIT ;    /* 0x0 */
        /*0040*/                   LDS.128 R4, [R2] ;    /* 0x0 */
        /*0050*/                   FMUL R8, R4, R5 ;    /* 0x0 */
        /*0060*/                   BSSY B1, 0xc0 ;    /* 0x0 */
        /*0070*/                   ISETP.GT.U32.AND P0, PT, R8, 0x1ffffff, PT ;    /* 0x0 */
        /*0080*/               @P0 BRA 0xb0 ;    /* 0x0 */
        /*0090*/                   CALL.REL.NOINC 0x200 ;    /* 0x0 */
        /*00a0*/                   BRA 0xc0 ;    /* 0x0 */
        /*00b0*/                   MUFU.RCP R9, R8 ;    /* 0x0 */
        /*00c0*/                   BSYNC B1 ;    /* 0x0 */
        /*00d0*/                   FSETP.GEU.AND P1, PT, R9, R10, PT ;    /* 0x0 */
        /*00e0*/                   FSEL R10, R9, R10, !P1 ;    /* 0x0 */
        /*00f0*/                   IADD3 R2, R2, 0x30, RZ ;    /* 0x0 */
        /*0100*/                   ISETP.GE.AND P2, PT, R2, R3, PT ;    /* 0x0 */
        /*0110*/                   NOP ;    /* 0x0 */
        /*0120*/              @!P2 BRA 0x40 ;    /* 0x0 */
        /*0130*/                   EXIT ;    /* 0x0 */
        /*0200*/                   MUFU.RCP R9, R8 ;    /* 0x0 */
        /*0210*/                   RET.REL.NODEC R2 0x0 ;    /* 0x0 */
        Function : _Z11other_kernelv
        /*0000*/                   EXIT ;    /* 0x0 */
"""


def test_sass_loop_counts_the_fast_path():
    from raytracingc_tpu_torch.tools import sass_loop

    fns = sass_loop.functions(_SASS)
    assert set(fns) == {"_Z19search_brute_kernelILi8ELb0EEvv", "_Z11other_kernelv"}
    (lp,) = sass_loop.loop_counts(fns["_Z19search_brute_kernelILi8ELb0EEvv"])
    # 15 instructions from 0x40 to 0x120, 2 skipped (the CALL and its BRA).
    assert (lp["head"], lp["end"]) == (0x40, 0x120)
    assert (lp["instructions"], lp["skipped"], lp["tests"]) == (13, 2, 1)
    assert lp["per_pair"] == 13.0
    assert sass_loop.loop_counts(fns["_Z11other_kernelv"]) == []
