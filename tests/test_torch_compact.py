"""The live-lane compaction's plain version, wrapper and route
(``raytracingc_tpu_torch/ops/compact.py``), on the CPU.

The plain version (:func:`compact_reference`, the wrapper's CPU branch)
equals the integrator's torch expressions as they stood before the kernel
(``torch.nonzero``, the gathers, the out-of-place write-back, copied below)
bit for bit over seeded masks: none live, all live, one lane, and lane
counts that are no multiple of the kernel's tile. The route is the shading
kernel's: here every call counts its lanes in ``compact.torch_lanes``;
with the card's test stubbed, every production compaction counts in
``compact.kernel_lanes``, runs the wrapper into the call's buffers and
gives the same image, while a gradient, a forward-AD level and a ``vmap``
keep the torch route. The host side of a launch (epochs, tickets, the
status words' growth) runs against a stand-in library. The kernel itself
runs on the card only (``chip_smoke.py``).
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from raytracingc_tpu_torch import rng
from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.ops import compact, shade
from raytracingc_tpu_torch.render.integrator import render_debug, trace_paths
from raytracingc_tpu_torch.render.renderer import render
from raytracingc_tpu_torch.scene import builder as tb
from raytracingc_tpu_torch.scene.types import with_leaves
from raytracingc_tpu_torch.utils.profiling import COUNTS, counters

BOX_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "box_scene.txt")
# (label, lanes, live share): none live, all live, one lane, a tile and
# one, lane counts that are no multiple of the tile.
MASKS = (("none", 1000, 0.0), ("all", 1000, 1.0), ("one live", 1, 1.0),
         ("one dead", 1, 0.0), ("tile+1", compact.TILE + 1, 0.3),
         ("3000", 3000, 0.7), ("777", 777, 0.01))
MODES = {
    "production": {},
    "fast_forward": dict(early_exit=False),
    "sample_group": dict(sample_group=2),
    "sample_batch": dict(sample_batch=2),
}
KEYS = ("compact.kernel_lanes", "compact.torch_lanes")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return tb.scene_from_triangles_txt(BOX_SCENE)


@pytest.fixture
def on_card(monkeypatch):
    """The route's device test answers "a card" for CPU tensors: the
    kernel route then runs the wrapper, whose CPU branch is the plain
    version."""
    monkeypatch.setattr(shade, "_on_card", lambda t: True)


def _bits(t):
    return t.detach().contiguous().view(torch.int32) if t.is_floating_point() else t


def _lanes(n, live, seed=5):
    """A seeded bounce's lane tensors: ids (ascending, not contiguous in
    the image), pos, d, thr, light [n, 3], states, and the mask."""
    g = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(g.normal(size=s).astype(np.float32))
    ids = torch.from_numpy(np.sort(g.choice(4 * n + 3, n, replace=False)))
    mask = torch.from_numpy(g.random(n) < live)
    return dict(ids=ids, pos=f32(n, 3), d=f32(n, 3), thr=f32(n, 3),
                state=torch.from_numpy(g.integers(0, 2**32, n, dtype=np.int64)),
                light=f32(n, 3), mask=mask, image=f32(4 * n + 3, 3))


def _counts(fn):
    before = dict(COUNTS)
    out = fn()
    return out, {k: COUNTS[k] - before[k] for k in KEYS}


def _render(scene, **kw):
    return render(scene, Camera.look_at(), 12, 10, spp=2, max_bounce=4, seed=3,
                  pixel_chunk=64, **kw)


# --- The plain version == the integrator's expressions before the kernel. ---


@pytest.mark.parametrize("label,n,live", MASKS, ids=[m[0] for m in MASKS])
def test_bounce_compaction_is_the_old_gathers_and_write_back(label, n, live):
    x = _lanes(n, live)
    payload = [x[k] for k in ("pos", "d", "thr", "state", "light")]
    # As the loop did: keep = nonzero(alive); the image written back out of
    # place (every lane), the lane tensors gathered; then the end of the
    # trace writes the survivors.
    keep = torch.nonzero(x["mask"]).squeeze(1)
    old_image = x["image"].index_copy(0, x["ids"], x["light"])
    old = [x["ids"][keep], *(t[keep] for t in payload)]
    old_image = old_image.index_copy(0, old[0], old[-1])

    outs = [torch.full((n + 5, *t.shape[1:]), -7, dtype=t.dtype) for t in payload]
    out_lanes = torch.full((n + 5,), -7, dtype=torch.int64)
    image = x["image"].clone()
    lanes, got = compact.compact_kernel(x["mask"], x["ids"], payload, outs,
                                        out_lanes, (x["light"], image))
    assert lanes.numel() == keep.numel() == int(x["mask"].sum())
    for a, b in zip((lanes, *got), old):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    # Only the dead lanes were written back; the survivors' rows are the
    # end's to write.
    dead = x["ids"][~x["mask"]]
    untouched = torch.ones(image.shape[0], dtype=torch.bool)
    untouched[dead] = False
    assert torch.equal(_bits(image[untouched]), _bits(x["image"][untouched]))
    image.index_copy_(0, lanes, got[-1])
    assert torch.equal(_bits(image), _bits(old_image))


@pytest.mark.parametrize("label,n,live", MASKS, ids=[m[0] for m in MASKS])
def test_entry_and_hit_front_compactions_are_the_old_gathers(label, n, live):
    """No lane ids in (the trace entry's ``arange``, the hit front's
    ``nonzero``): the kept lanes' indices, and rows of 4, 8 and 12 bytes."""
    x = _lanes(n, live, seed=9)
    payload = [x["pos"], x["state"], x["light"][:, 0].contiguous(), x["ids"]]
    keep = torch.nonzero(x["mask"]).squeeze(1)
    outs = [torch.empty((n, *t.shape[1:]), dtype=t.dtype) for t in payload]
    lanes, got = compact.compact_kernel(x["mask"], None, payload, outs,
                                        torch.empty(n, dtype=torch.int64))
    assert torch.equal(lanes, keep)
    for a, t in zip(got, payload):
        assert torch.equal(_bits(a), _bits(t[keep]))
    m = compact.compact_reference(x["mask"], None, payload, outs,
                                  torch.empty(n, dtype=torch.int64))
    assert m == keep.numel()


def test_empty_mask_writes_nothing():
    outs = [torch.zeros((4, 3))]
    lanes, got = compact.compact_kernel(torch.zeros(0, dtype=torch.bool), None,
                                        [torch.zeros((0, 3))], outs,
                                        torch.zeros(4, dtype=torch.int64))
    assert lanes.numel() == 0 and got[0].shape == (0, 3)


# --- The wrapper's checks. ---------------------------------------------------


def _good(n=8):
    return dict(mask=torch.ones(n, dtype=torch.bool), lanes=torch.arange(n),
                payload=[torch.zeros((n, 3))], outs=[torch.zeros((n, 3))],
                out_lanes=torch.zeros(n, dtype=torch.int64),
                writeback=(torch.zeros((n, 3)), torch.zeros((2 * n, 3))))


# fault -> (the arguments it replaces, the message it raises).
FAULTS = {
    "mask dtype": (lambda a: dict(mask=a["mask"].to(torch.uint8)), "mask is"),
    "mask shape": (lambda a: dict(mask=a["mask"][None]), "mask is"),
    "mask contiguity": (lambda a: dict(mask=torch.ones(16, dtype=torch.bool)[::2]),
                        "mask is"),
    "lanes dtype": (lambda a: dict(lanes=a["lanes"].int()), "lanes is"),
    "lanes shape": (lambda a: dict(lanes=torch.arange(9)), "lanes has shape"),
    "payload dtype": (lambda a: dict(outs=[torch.zeros((8, 3), dtype=torch.float64)]),
                      "rows differ"),
    "payload shape": (lambda a: dict(payload=[torch.zeros((7, 3))]),
                      "payload.0. has shape"),
    "payload contiguity": (lambda a: dict(payload=[torch.zeros((3, 8)).t()]),
                           "not contiguous"),
    "payload rows": (lambda a: dict(payload=[torch.zeros((8, 3), dtype=torch.bool)],
                                    outs=[torch.zeros((8, 3), dtype=torch.bool)]),
                     "32-bit words"),
    "payload wide rows": (lambda a: dict(payload=[torch.zeros((8, 5))],
                                         outs=[torch.zeros((8, 5))]), "32-bit words"),
    "too many payloads": (lambda a: dict(payload=[torch.zeros((8, 3))] * 9),
                          "at most 8"),
    "outs too short": (lambda a: dict(outs=[torch.zeros((7, 3))]), "outs.0. has shape"),
    "outs no dimension": (lambda a: dict(outs=[torch.zeros(())]), "rows differ"),
    "out_lanes too short": (lambda a: dict(out_lanes=torch.zeros(7, dtype=torch.int64)),
                            "out_lanes has shape"),
    "writeback rows": (lambda a: dict(writeback=(torch.zeros((8, 3)),
                                                 torch.zeros((16, 2)))),
                       "rows differ"),
    "payload device": (lambda a: dict(payload=[torch.zeros((8, 3), device="meta")]),
                       "is on meta"),
    "writeback device": (lambda a: dict(writeback=(torch.zeros((8, 3)),
                                                   torch.zeros((16, 3), device="meta"))),
                         "is on meta"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_wrapper_checks_raise(fault):
    make, match = FAULTS[fault]
    args = _good()
    args.update(make(args))
    with pytest.raises(ValueError, match="compact_kernel: .*" + match):
        compact.compact_kernel(**args)
    compact.compact_kernel(**_good())  # the good arguments pass


def test_wrapper_refuses_other_devices():
    args = {k: ([t.to("meta") for t in v] if isinstance(v, list)
                else tuple(t.to("meta") for t in v) if isinstance(v, tuple)
                else v.to("meta")) for k, v in _good().items()}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        compact.compact_kernel(**args)


# --- The host side of a launch, against a stand-in library. ------------------


class _Lib:
    """Records each ``rtc_compact`` call and answers the count the plain
    version gives on the same (CPU) tensors."""

    def __init__(self):
        self.calls, self.words = [], 0

    def rtc_compact_word(self, at):
        self.words += 1
        ctypes.c_void_p.from_address(at).value = 0x1000 * self.words
        return 0

    def rtc_compact(self, *a):
        desc, k = list(a[3]), a[4]  # the descriptors: a host array (or a list)
        assert len(desc) == 3 * (k + 1)
        self.calls.append(dict(n=a[2], k=k, wb_bytes=desc[-1], status=a[6],
                               base=a[8], epoch=a[9], word=a[10]))
        ctypes.c_int.from_address(a[11]).value = self.count
        return 0


def test_launch_state_takes_epochs_tickets_and_grows(monkeypatch):
    lib, stream = _Lib(), 0xABC
    monkeypatch.setattr(compact, "_scratch", {})
    x = _lanes(3000, 0.5)
    payload = [x["pos"], x["state"]]
    launches = compact.compact_kernel.launches
    for n, want in ((3000, 1500), (1024, 3), (1, 1), (5 * compact.TILE + 1, 0)):
        lib.count = want
        mask = torch.ones(n, dtype=torch.bool)
        big = [torch.zeros((n, *t.shape[1:]), dtype=t.dtype) for t in payload]
        out = compact.Outputs([torch.zeros_like(t) for t in big],
                              torch.zeros(n, dtype=torch.int64))
        assert out._fill(mask, None, big, (big[0], torch.zeros((n, 3))) if n == 1 else None)
        assert list(out.desc[2::3]) == [12, 8, 12 if n == 1 else 0]
        assert compact._launch(lib, stream, mask, None, out.desc, 2,
                               out.out_lanes) == want
    calls = lib.calls
    tiles = [-(-n // compact.TILE) for n in (3000, 1024, 1, 5 * compact.TILE + 1)]
    assert lib.words == 1 and len({c["word"] for c in calls}) == 1
    assert [c["epoch"] for c in calls] == [1, 2, 3, 4]
    assert [c["k"] for c in calls] == [2] * 4
    # Each launch takes one ticket a tile.
    assert [c["base"] for c in calls] == [0, *np.cumsum(tiles[:-1])]
    assert [c["wb_bytes"] for c in calls] == [0, 0, 12, 0]
    s = compact._scratch[(None, stream)]
    assert s.taken == sum(tiles) and s.words == s.status.numel() == compact.STATUS_WORDS
    assert compact.compact_kernel.launches == launches + 4
    # More tiles than status words: the words grow (to twice as many).
    lib.count = 0
    n = compact.STATUS_WORDS * compact.TILE + 1
    compact._launch(lib, stream, torch.zeros(n, dtype=torch.bool), None, [0, 0, 0], 0,
                    torch.zeros(n, dtype=torch.int64))
    taken = sum(tiles) + compact.STATUS_WORDS + 1
    assert s.words == s.status.numel() == 2 * compact.STATUS_WORDS and s.taken == taken
    assert calls[-1]["status"] == s.status.data_ptr()
    # The epoch wraps past 0 to 1, zeroing the status words on the way.
    out_lanes = torch.empty(1, dtype=torch.int64)
    s.epoch, s.status[:] = 2**32 - 1, 7
    lib.count = 0
    compact._launch(lib, stream, torch.zeros(1, dtype=torch.bool), None, [0, 0, 0], 0,
                    out_lanes)
    assert calls[-1]["epoch"] == 1 and not s.status.any()
    assert calls[-1]["base"] == taken
    # Another stream has its own scratch.
    compact._launch(lib, stream + 1, torch.zeros(1, dtype=torch.bool), None,
                    [0, 0, 0], 0, out_lanes)
    assert lib.words == 2 and calls[-1]["epoch"] == 1 and calls[-1]["base"] == 0


def test_buffers_are_allocated_once_a_set():
    x = _lanes(600, 0.5)
    comp = compact.Buffers(600)
    ptrs = []
    for _ in range(4):
        lanes, (pos,) = comp(x["mask"], None, [x["pos"]])
        ptrs.append((lanes.data_ptr(), pos.data_ptr()))
    assert ptrs[0] == ptrs[2] and ptrs[1] == ptrs[3] and ptrs[0] != ptrs[1]
    assert [len(s.outs) for s in comp.sets] == [1, 1]


# --- The route. ---------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_cpu_call_takes_the_torch_route(scene, mode):
    _, lanes = _counts(lambda: _render(scene, **MODES[mode]))
    assert lanes["compact.kernel_lanes"] == 0 and lanes["compact.torch_lanes"] > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kernel_route_takes_every_lane_and_keeps_the_bits(scene, mode, monkeypatch):
    (img, n), torch_lanes = _counts(lambda: _render(scene, **MODES[mode]))
    monkeypatch.setattr(shade, "_on_card", lambda t: True)
    (got, m), lanes = _counts(lambda: _render(scene, **MODES[mode]))
    assert lanes["compact.torch_lanes"] == 0
    assert lanes["compact.kernel_lanes"] == torch_lanes["compact.torch_lanes"] > 0
    assert torch.equal(_bits(got), _bits(img)) and m == n


def test_oracle_and_heatmap_compact_nothing(scene, on_card):
    _, lanes = _counts(lambda: _render(scene, early_exit=False, compact=False))
    assert lanes == dict.fromkeys(KEYS, 0)
    _, lanes = _counts(lambda: render_debug(scene, Camera.look_at(), 8, 6, 3))
    assert lanes == dict.fromkeys(KEYS, 0)


@pytest.mark.parametrize("active", ("none", "masked"))
def test_trace_paths_entry_on_either_route(scene, active, monkeypatch):
    """``trace_paths`` called directly: no first hit, ``active`` None (the
    entry's ids are an arange) or a mask."""
    o, d = primary_rays(Camera.look_at(), 10, 8)
    state = rng.stream_init(3, torch.arange(80), 0)
    act = None if active == "none" else torch.arange(80) % 3 != 0
    want, n = trace_paths(o, d, state, scene, 4, active=act)
    monkeypatch.setattr(shade, "_on_card", lambda t: True)
    (got, m), lanes = _counts(lambda: trace_paths(o, d, state, scene, 4, active=act))
    assert lanes["compact.kernel_lanes"] > 0 and lanes["compact.torch_lanes"] == 0
    assert torch.equal(_bits(got), _bits(want)) and m == n


def test_a_scene_leaf_requiring_grad_takes_the_torch_route(scene, on_card):
    albedo = scene.triangles.albedo.clone().requires_grad_(True)
    s = with_leaves(scene, {".triangles.albedo": albedo})
    (img, _), lanes = _counts(lambda: _render(s, early_exit=False))
    assert lanes["compact.kernel_lanes"] == 0 and lanes["compact.torch_lanes"] > 0
    img.sum().backward()
    assert albedo.grad is not None and albedo.grad.abs().sum() > 0
    with torch.no_grad():  # nothing can see a derivative: the kernel route
        _, lanes = _counts(lambda: _render(s, early_exit=False))
    assert lanes["compact.torch_lanes"] == 0 and lanes["compact.kernel_lanes"] > 0


def test_a_forward_ad_level_takes_the_torch_route(scene, on_card):
    albedo = scene.triangles.albedo
    with torch.autograd.forward_ad.dual_level():
        dual = torch.autograd.forward_ad.make_dual(albedo, torch.ones_like(albedo))
        _, lanes = _counts(lambda: _render(with_leaves(scene, {".triangles.albedo": dual})))
        assert lanes["compact.kernel_lanes"] == 0 and lanes["compact.torch_lanes"] > 0
        # An open level alone, with no dual among the inputs.
        _, lanes = _counts(lambda: _render(scene))
        assert lanes["compact.kernel_lanes"] == 0 and lanes["compact.torch_lanes"] > 0


def test_vmap_takes_the_torch_route(scene, on_card):
    albedo = scene.triangles.albedo
    f = lambda a: _render(with_leaves(scene, {".triangles.albedo": a}))[0]
    imgs, lanes = _counts(lambda: torch.func.vmap(f)(torch.stack([albedo, albedo * 0.5])))
    assert lanes["compact.kernel_lanes"] == 0 and lanes["compact.torch_lanes"] > 0
    assert torch.equal(_bits(imgs[1]), _bits(f(albedo * 0.5)))


def test_counters_report_the_wrapper_and_the_lanes(monkeypatch):
    monkeypatch.setattr(compact.compact_kernel, "launches", 4321)
    snap = counters()
    assert snap["launches.compact_kernel"] == 4321
    assert set(KEYS) <= set(snap)
    before = dict(COUNTS)
    compact.tally(True, 5)
    compact.tally(False, 7)
    assert COUNTS["compact.kernel_lanes"] - before["compact.kernel_lanes"] == 5
    assert COUNTS["compact.torch_lanes"] - before["compact.torch_lanes"] == 7


def test_cpu_branch_counts_no_launch(scene, on_card):
    launches = compact.compact_kernel.launches
    _render(scene)
    assert compact.compact_kernel.launches == launches
