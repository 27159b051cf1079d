"""The integrator's live-lane compaction: the CUDA kernel, its plain version
and the buffers its outputs go to.

Each bounce of ``render/integrator.py`` runs on the live lanes only. Eager
torch selects them with ``torch.nonzero`` (cub's select, a copy of the
count to the host, a sync), writes the dead lanes' radiance back with an
out-of-place ``index_copy`` and gathers each lane tensor on its own: ~13
launches a bounce. ``csrc/compact.cu`` (:func:`compact_kernel`) does it in
one launch and one read of the count, for the integrator's three
compactions (the trace entry, every bounce, the hit front's selection):
each lane whose mask is set is copied, all its rows, to slot ``rank(i)``
(the set lanes before it) of every output, the order of ``torch.nonzero``;
each lane whose mask is clear may write a row back into a full-width
tensor in place.

**The route** (:func:`route`) is the shading kernel's (``ops/shade.py``
``kernel_route``): the kernel where the tensors are on a card and no
derivative can be seen; otherwise the integrator's torch code, unchanged.
The integrator decides it once a call, and counts the lanes it hands to
each compaction in ``compact.kernel_lanes`` or ``compact.torch_lanes``
(``utils/profiling.py``).

:func:`compact_kernel` is the wrapper: a CUDA tensor launches the kernel
(counted in ``compact_kernel.launches``) or raises on a wrong device,
dtype, shape or contiguity; a CPU tensor runs the plain version
(:func:`compact_reference`). Its outputs are prefixes of buffers sized to
the most lanes a call can keep, which :class:`Buffers` allocates once per
integrator call, not once a bounce; :class:`Outputs` reads them once, so
that each bounce checks only its inputs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from raytracingc_tpu_torch.ops import _build, shade
from raytracingc_tpu_torch.utils.profiling import COUNTS

MAX_PAYLOAD = 8  # csrc/compact.cu kMaxPayload
MAX_ROW = 16     # bytes a row, at most (csrc/compact.cu kMaxWords words)
TILE = 256       # lanes a CTA (csrc/compact.cu kThreads)
MAX_LANES = 2**31 - 1 - TILE  # the kernel indexes lanes in int32
STATUS_WORDS = 4096  # status words first allocated: 1,048,576 lanes
_M32 = 0xFFFFFFFF


def compact_reference(mask, lanes, payload, outs, out_lanes, writeback=None) -> int:
    """Plain version of :func:`compact_kernel`: the integrator's torch
    expressions. ``keep = nonzero(mask)``; ``out_lanes[:m]`` takes
    ``lanes[keep]`` (``keep`` when ``lanes`` is None) and each ``outs[q][:m]``
    takes ``payload[q][keep]``; with ``writeback = (src, dst)`` each dead
    lane's ``src`` row goes to ``dst[lanes[i]]`` in place. Returns ``m``."""
    keep = torch.nonzero(mask).squeeze(1)
    m = keep.numel()
    if writeback is not None:
        src, dst = writeback
        dead = torch.nonzero(~mask).squeeze(1)
        dst.index_copy_(0, dead if lanes is None else lanes[dead], src[dead])
    out_lanes[:m] = keep if lanes is None else lanes[keep]
    for x, out in zip(payload, outs):
        out[:m] = x[keep]
    return m


def _fail(what: str):
    raise ValueError(f"compact_kernel: {what}")


def _row_bytes(name, x, n, device, exact=True) -> int:
    """The bytes of one row of ``x`` (``[n, ...]``; ``[>= n, ...]`` unless
    ``exact``), which must be contiguous on ``device``, 4-byte aligned and
    a whole number of 32-bit words."""
    if x.device != device:
        _fail(f"{name} is on {x.device}, not {device}")
    if x.dim() < 1 or (x.shape[0] != n if exact else x.shape[0] < n):
        _fail(f"{name} has shape {tuple(x.shape)}, expected {'' if exact else '>= '}"
              f"{n} rows")
    if not x.is_contiguous():
        _fail(f"{name} is not contiguous")
    row = math.prod(x.shape[1:]) * x.element_size()
    if row % 4 or row > MAX_ROW or x.data_ptr() % 4:
        _fail(f"{name}: rows of {row} bytes at {x.data_ptr():#x}; the kernel "
              f"copies 1 to 4 aligned 32-bit words a row")
    return row


def _check_args(mask, lanes, payload, outs, out_lanes, writeback) -> None:
    """Raise ``ValueError`` naming what the kernel does not take."""
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        _fail(f"mask is {mask.dtype} {tuple(mask.shape)}, expected a contiguous "
              f"bool [n]")
    n, dev = mask.shape[0], mask.device
    if n > MAX_LANES:
        _fail(f"{n} lanes; the kernel indexes at most {MAX_LANES} in int32")
    if out_lanes is None:
        _fail("out_lanes is None")
    for name, x, exact in (("lanes", lanes, True), ("out_lanes", out_lanes, False)):
        if x is not None:
            if x.dtype != torch.int64 or x.dim() != 1:
                _fail(f"{name} is {x.dtype} {tuple(x.shape)}, expected int64 [n]")
            _row_bytes(name, x, n, dev, exact)
    if len(payload) != len(outs) or len(payload) > MAX_PAYLOAD:
        _fail(f"{len(payload)} payload tensors and {len(outs)} outputs; "
              f"expected as many of each, at most {MAX_PAYLOAD}")
    # (input, output, the rows the output must hold): a payload's output
    # takes up to n rows, the write-back's target any row an id names.
    pairs = [(f"payload[{q}]", x, f"outs[{q}]", o, n)
             for q, (x, o) in enumerate(zip(payload, outs))]
    if writeback is not None:
        pairs.append(("writeback src", writeback[0], "writeback dst", writeback[1], 0))
    for name, x, out_name, out, least in pairs:
        if out.dtype != x.dtype or out.shape[1:] != x.shape[1:]:
            _fail(f"{out_name} is {out.dtype} {tuple(out.shape)}, {name} "
                  f"{x.dtype} {tuple(x.shape)}: rows differ")
        _row_bytes(name, x, n, dev)
        _row_bytes(out_name, out, least, dev, exact=False)


class _Scratch:
    """What the kernel keeps between launches on one stream of one card:
    the tiles' status words (tagged by the launch's epoch), the ticket
    counter and the tickets it has handed out, and the pinned host word of
    the count."""

    def __init__(self, lib, device):
        word = ctypes.c_void_p()
        _build.check(lib.rtc_compact_word(ctypes.addressof(word)),
                     "compact_kernel host word")
        self.word, self.device = word.value, device
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.grow(STATUS_WORDS)
        self.taken = self.epoch = 0
        self.count = ctypes.c_int()
        self.count_at = ctypes.addressof(self.count)

    def grow(self, words: int) -> None:
        self.status = torch.zeros(words, dtype=torch.int64, device=self.device)
        self.words, self.status_at = words, self.status.data_ptr()


_scratch: dict = {}  # (card index, raw stream handle) -> _Scratch


def _launch(lib, stream, mask, lanes, desc, k, out_lanes) -> int:
    n, dev = mask.shape[0], mask.device
    key = (dev.index, stream)  # a CUDA tensor's device always has its index
    s = _scratch.get(key)
    if s is None:
        s = _scratch[key] = _Scratch(lib, dev)
    tiles = -(-n // TILE)
    if tiles > s.words:
        s.grow(max(tiles, 2 * s.words))
    s.epoch = (s.epoch + 1) & _M32
    if s.epoch == 0:  # every 2**32 launches: no stale word may carry the epoch
        s.status.zero_()
        s.epoch = 1
    code = lib.rtc_compact(
        mask.data_ptr(), None if lanes is None else lanes.data_ptr(), n, desc, k,
        out_lanes.data_ptr(), s.status_at, s.ticket.data_ptr(), s.taken, s.epoch,
        s.word, s.count_at, stream)
    _build.check(code, "compact_kernel launch")
    s.taken = (s.taken + tiles) & _M32
    compact_kernel.launches += 1
    return s.count.value


class Outputs:
    """Where compactions write: ``out_lanes`` (int64 ``[cap]``) and
    ``outs`` (a tensor ``[cap, ...]`` a payload), read once, with the
    kernel's row descriptors (``in, out, row bytes`` a payload, then the
    write-back's) in a host array whose outputs are filled in here; each
    call fills in its inputs. Calling it is :func:`compact_kernel` on these
    outputs."""

    def __init__(self, outs, out_lanes):
        self.outs, self.out_lanes = list(outs), out_lanes
        self.device = out_lanes.device
        k = len(self.outs)
        self.desc = (ctypes.c_uint64 * (3 * (k + 1)))()
        self.dtypes = [o.dtype for o in self.outs]
        self.rows = [math.prod(o.shape[1:]) * o.element_size() for o in self.outs]
        # Whether every output is one the kernel takes; otherwise each call
        # goes through _check_args, which names the fault.
        self.fit = (k <= MAX_PAYLOAD and out_lanes.dtype is torch.int64
                    and out_lanes.dim() == 1 and out_lanes.is_contiguous() and all(
                        o.dim() >= 1 and o.is_contiguous() and o.device == self.device
                        and 0 < row <= MAX_ROW and not row & 3
                        for o, row in zip(self.outs, self.rows)))
        self.cap = min(x.shape[0] if x.dim() else 0 for x in (out_lanes, *self.outs))
        for q, (o, row) in enumerate(zip(self.outs, self.rows)):
            self.desc[3 * q + 1], self.desc[3 * q + 2] = o.data_ptr(), row

    def _fill(self, mask, lanes, payload, writeback) -> bool:
        """Whether the inputs fit (a lean pass: it runs on every bounce),
        their pointers written into the descriptors."""
        desc, dev = self.desc, self.device
        n = mask.shape[0]
        ok = (self.fit and mask.dtype is torch.bool and mask.dim() == 1
              and mask.is_contiguous() and mask.device == dev and n <= self.cap
              and n <= MAX_LANES and len(payload) == len(self.outs))
        if ok and lanes is not None:
            ok = (lanes.dtype is torch.int64 and lanes.dim() == 1 and lanes.shape[0] == n
                  and lanes.is_contiguous() and lanes.device == dev)
        for q, x in enumerate(payload):
            if not ok:
                return False
            ptr = x.data_ptr()
            ok = (x.dtype is self.dtypes[q] and x.dim() >= 1 and x.shape[0] == n
                  and x.nbytes == n * self.rows[q] and x.is_contiguous()
                  and x.device == dev and not ptr & 3)
            desc[3 * q] = ptr
        w = 3 * len(payload)
        if ok and writeback is not None:
            src, dst = writeback
            ok = (src.dtype is dst.dtype and src.dim() == dst.dim() >= 1
                  and src.shape[0] == n and src.is_contiguous() and dst.is_contiguous()
                  and src.device == dev and dst.device == dev)
            if ok and n:
                row, pin, pout = src.nbytes // n, src.data_ptr(), dst.data_ptr()
                ok = (dst.nbytes == dst.shape[0] * row and 0 < row <= MAX_ROW
                      and not (row & 3 or (pin | pout) & 3))
                desc[w], desc[w + 1], desc[w + 2] = pin, pout, row
        elif ok:
            desc[w] = desc[w + 1] = desc[w + 2] = 0
        return ok

    def __call__(self, mask, lanes, payload, writeback=None):
        try:
            ok = self._fill(mask, lanes, payload, writeback)
        except IndexError:  # a tensor with no dimension
            ok = False
        if not ok:
            _check_args(mask, lanes, payload, self.outs, self.out_lanes, writeback)
            _fail("arguments the kernel does not take")
        dev = self.device
        if dev.type == "cpu":
            m = compact_reference(mask, lanes, payload, self.outs, self.out_lanes,
                                  writeback)
        elif dev.type != "cuda":
            raise RuntimeError(f"compact_kernel: no kernel for device {dev}")
        elif mask.shape[0] == 0:
            m = 0
        else:
            with _build.card(dev) as (lib, stream):
                m = _launch(lib, stream, mask, lanes, self.desc, len(self.outs),
                            self.out_lanes)
        return self.out_lanes[:m], [o[:m] for o in self.outs]


def compact_kernel(mask, lanes, payload, outs, out_lanes, writeback=None):
    """Compact the lanes of a bool ``mask [n]``: ``(out_lanes[:m],
    [o[:m] for o in outs])``, the ids of the ``m`` set lanes in order
    (``lanes[i]``, or ``i`` where ``lanes`` is None) and each ``payload``
    tensor's rows of those lanes; with ``writeback = (src [n, ...], dst)``
    each clear lane's ``src`` row is written to ``dst[id]`` in place. The
    outputs ``outs`` (``[>= n, ...]``, each of its payload's dtype and row)
    and ``out_lanes`` (int64 ``[>= n]``) alias no input. At most
    :data:`MAX_PAYLOAD` payloads, every row 1 to 4 whole 32-bit words.

    A CPU tensor runs :func:`compact_reference`. A CUDA tensor launches
    ``csrc/compact.cu`` on the current stream (building the library on
    first use), waits for it and reads the count from pinned host memory;
    the launch is counted in ``compact_kernel.launches`` (none at n = 0).
    Any other device raises. :class:`Outputs` keeps the outputs' part for
    repeated calls."""
    return Outputs(outs, out_lanes)(mask, lanes, payload, writeback)


compact_kernel.launches = 0


def route(scene, *tensors) -> bool:
    """Whether an integrator call's compactions on ``tensors`` take the
    kernel: the shading kernel's rule (``ops/shade.py`` ``kernel_route``),
    the tensors on a card and no derivative to be seen in them or in the
    scene's leaves."""
    return shade.kernel_route(scene, *tensors)


def tally(kernel: bool, n: int) -> None:
    """Count ``n`` lanes handed to a compaction on its route."""
    COUNTS["compact.kernel_lanes" if kernel else "compact.torch_lanes"] += n


class Buffers:
    """The outputs of one integrator call's compactions on the kernel
    route: ``sets`` sets of :class:`Outputs` used in turn (two where each
    compaction reads the last one's outputs), each allocated at its first
    use with room for ``cap`` lanes and the rows of that use's payload."""

    def __init__(self, cap: int, sets: int = 2):
        self.cap, self.sets, self.turn = cap, [None] * sets, 0

    def __call__(self, mask, lanes, payload, writeback=None):
        """The next set's :class:`Outputs` on these inputs."""
        k, self.turn = self.turn, (self.turn + 1) % len(self.sets)
        if self.sets[k] is None:
            dev = mask.device
            self.sets[k] = Outputs(
                [torch.empty((self.cap, *x.shape[1:]), dtype=x.dtype, device=dev)
                 for x in payload],
                torch.empty((self.cap,), dtype=torch.int64, device=dev))
        return self.sets[k](mask, lanes, payload, writeback)
