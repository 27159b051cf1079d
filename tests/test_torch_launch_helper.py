"""The one way onto the card (``ops/_build.py`` :func:`card`) on the CPU.

The kernel library, the current card, torch's device guard and the raw
stream call are stubbed: the current card takes no device guard, another
card takes it, the stream handle reaches the entry as its last argument,
and a nonzero code raises ``CudaError`` with the calling wrapper's text.
"""

import contextlib

import pytest
import torch

from raytracingc_tpu_torch.ops import _build, search_brute, search_range, shade

CURRENT = 0
STREAM = 0x5000  # the stub's raw stream handle of card i is STREAM + i


class FakeLib:
    """Every ``rtc_*`` entry records its arguments and returns ``code``."""

    def __init__(self):
        self.calls = []
        self.code = 0

    def __getattr__(self, name):
        if name == "rtc_error_string":
            return lambda code: b"an injected fault"

        def entry(*args):
            self.calls.append((name, args))
            return self.code

        return entry


@pytest.fixture
def stubs(monkeypatch):
    """``(lib, guards)``: the fake library and the cards the device guard
    was entered for."""
    lib, guards = FakeLib(), []

    @contextlib.contextmanager
    def device(index):
        guards.append(index)
        yield

    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: CURRENT)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: STREAM + i,
                        raising=False)
    monkeypatch.setattr(shade.shade_kernel, "launches", 0)
    monkeypatch.setattr(search_brute.search_brute, "launches", 0)
    return lib, guards


@pytest.mark.parametrize("device", [torch.device("cuda", CURRENT), "cuda", "cuda:0"])
def test_the_current_card_takes_no_guard(stubs, device):
    lib, guards = stubs
    with _build.card(device) as (got, stream):
        assert got is lib and stream == STREAM + CURRENT
    assert guards == []


@pytest.mark.parametrize("device", [torch.device("cuda", 1), "cuda:1"])
def test_another_card_takes_the_guard(stubs, device):
    lib, guards = stubs
    with _build.card(device) as (got, stream):
        assert got is lib and stream == STREAM + 1
        assert guards == [1]
    assert guards == [1]


def _brute():
    o = torch.zeros((5, 3))
    tri = torch.zeros((4, 12))
    return search_brute._launch("rtc_search_brute", o, o, None, (tri,), 4)


def _unpack():
    return search_range.unpack_keys_cuda(torch.zeros((6,), dtype=torch.int64))


def _shade():
    return shade._call("step", torch.device("cuda", 1), 4, "tables", 7)


WRAPPERS = {  # name: (call, entry, its CudaError text, card)
    "search_brute": (_brute, "rtc_search_brute", "search_brute launch", CURRENT),
    "unpack_keys": (_unpack, "rtc_unpack_keys", "unpack_keys launch", CURRENT),
    "shade_kernel": (_shade, "rtc_shade_step", "shade_kernel step launch", 1),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_the_stream_handle_reaches_the_entry(stubs, name):
    lib, guards = stubs
    call, entry, _, index = WRAPPERS[name]
    call()
    ((got, args),) = lib.calls
    assert got == entry and args[-1] == STREAM + index
    assert guards == ([] if index == CURRENT else [index])
    # The ints go to ctypes as they are: _SIGNATURES types each argument.
    assert all(isinstance(a, (int, str)) or a is None for a in args)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_a_nonzero_code_raises_with_the_wrappers_text(stubs, name):
    lib, _ = stubs
    call, _, what, _ = WRAPPERS[name]
    lib.code = 700
    with pytest.raises(_build.CudaError,
                       match=f"^{what}: CUDA error 700 \\(an injected fault\\)$") as err:
        call()
    assert err.value.code == 700
    assert shade.shade_kernel.launches == search_brute.search_brute.launches == 0
