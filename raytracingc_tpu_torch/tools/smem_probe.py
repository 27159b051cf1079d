"""Shared-memory probe (K10): the largest table a CUDA kernel can hold.

Counterpart of ``tools/smem_probe.py``, which finds the TPU's scalar-memory
ceiling for the culling tables. Here the kernel (``csrc/smem_probe.cu``)
stages an ``n``-word int32 table in dynamic shared memory and computes the
TPU kernel's function, one CTA per 8 x 128 tile of ``x``::

    o = x + f32(sm[pid] + sm[n - 1 - pid] + sm[n // 2])

The ladder of table sizes brackets the device's opt-in maximum of shared
memory per block; each size prints ``OK`` (the kernel ran and equals
:func:`smem_probe_reference` bit for bit) or ``FAIL`` (the launch was
refused), and the probe stops at the first refusal, as the TPU tool does.

    python -m raytracingc_tpu_torch.tools.smem_probe [--device cuda|cpu]

On the CPU it runs the plain version, which has no limit, over the ladder
of an H100.
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100 (and H200), in bytes:
# the CPU run's ladder.
H100_OPTIN_BYTES = 232448
TILE_ROWS = 8
TILE_COLS = 128
X_SHAPE = (64, TILE_COLS)  # the TPU tool's input: 8 tiles
CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue: a refused launch


def smem_probe_reference(sm, x):
    """Plain PyTorch version: ``x + f32(sm[g] + sm[n-1-g] + sm[n//2])`` on
    the rows of tile ``g`` (int32 sums wrap)."""
    n = sm.shape[0]
    g = torch.arange(x.shape[0] // TILE_ROWS, device=x.device)
    s = sm[g].long() + sm[n - 1 - g].long() + sm[n // 2].long()
    s = ((s + 2**31) % 2**32 - 2**31).to(torch.int32)
    return x + s.to(torch.float32).repeat_interleave(TILE_ROWS)[:, None]


# The kernel's staging split (csrc/smem_probe.cu staging_body): the bulk
# copies stop at least TAIL_MIN words short of n, whose first 8 bytes hold
# the copies' mbarrier.
TAIL_MIN = 2


def staging_split(n: int) -> tuple[int, int]:
    """``(body, tail)`` in words: the kernel stages ``[0, body)`` by bulk
    copies (a multiple of 4 words, 16 bytes) and ``[body, n)`` by plain
    loads, ``tail`` of them (TAIL_MIN to TAIL_MIN + 3, or all of a table
    of fewer than 6 words, which has no bulk copy)."""
    body = (n - TAIL_MIN) // 4 * 4 if n >= 4 + TAIL_MIN else 0
    return body, n - body


def _check_args(sm, x):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != TILE_COLS \
            or x.shape[0] % TILE_ROWS or x.shape[0] == 0:
        raise ValueError(f"x: expected float32 [8k, {TILE_COLS}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if sm.dtype != torch.int32 or sm.dim() != 1:
        raise ValueError(f"sm: expected int32 [n], got {sm.dtype} {tuple(sm.shape)}")
    if sm.shape[0] < x.shape[0] // TILE_ROWS:
        raise ValueError(f"sm: {sm.shape[0]} words, fewer than the "
                         f"{x.shape[0] // TILE_ROWS} tiles of x")
    for name, t in (("sm", sm), ("x", x)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: expected a contiguous tensor on x's device")


_limit_set: set[int] = set()  # CUDA devices whose kernel's limit is raised


def smem_probe(sm, x, *, launches: int = 1, set_limit: bool = False):
    """``o = x + f32(...)`` with the table staged in shared memory.

    A CPU tensor runs :func:`smem_probe_reference`. A CUDA tensor launches
    ``csrc/smem_probe.cu`` with ``4 n`` bytes of dynamic shared memory and
    counts the launch in ``smem_probe.launches``; a refused launch raises
    ``_build.CudaError`` (code 1, cudaErrorInvalidValue, past the device's
    limit); any other device raises. The kernel's limit is raised to
    :func:`optin_bytes` on a device's first launch. For measurements:
    ``launches`` repeats the launch back to back into the same output from
    one C call, ``set_limit`` raises the limit again before the launch, as
    every call did before it was cached.
    """
    _check_args(sm, x)
    dev = x.device
    if dev.type == "cpu":
        return smem_probe_reference(sm, x)
    if dev.type != "cuda":
        raise RuntimeError(f"smem_probe: no kernel for device {dev}")
    if sm.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("sm, x: the kernel needs 16-byte aligned tensors")

    from raytracingc_tpu_torch.ops import _build

    out = torch.empty_like(x)
    with _build.card(dev) as (lib, stream):
        if set_limit or dev.index not in _limit_set:
            _build.check(lib.rtc_smem_set_limit(optin_bytes(dev)),
                         "cudaFuncSetAttribute")
            _limit_set.add(dev.index)
        code = lib.rtc_smem_probe(sm.data_ptr(), x.data_ptr(), sm.shape[0],
                                  x.shape[0] // TILE_ROWS, out.data_ptr(), launches,
                                  stream)
    _build.check(code, "smem_probe launch")
    smem_probe.launches += launches
    return out


smem_probe.launches = 0


@functools.cache
def _optin(index: int) -> int:
    import ctypes

    from raytracingc_tpu_torch.ops import _build

    out = ctypes.c_int(0)
    _build.check(_build.load_library().rtc_smem_optin(index, ctypes.byref(out)),
                 "cudaDeviceGetAttribute")
    return out.value


def optin_bytes(device) -> int:
    """The device's opt-in maximum of shared memory per block, in bytes
    (the H100's on the CPU, which has none); read once per device."""
    device = torch.device(device)
    if device.type == "cpu":
        return H100_OPTIN_BYTES
    return _optin(device.index if device.index is not None
                  else torch.cuda.current_device())


def ladder(limit_bytes: int) -> list[int]:
    """Table sizes in int32 words: 48, 64, 128, 192 and 224 KiB, the limit
    itself, one word past it, and 256 KiB."""
    words = limit_bytes // 4
    return sorted({12288, 16384, 32768, 49152, 57344, words, words + 1, 65536})


def run_ladder(device, sizes):
    """Probe each size in order; ``[(n, equal to the plain version, the
    refusal or None)]``, stopping after the first refusal."""
    from raytracingc_tpu_torch.ops._build import CudaError

    x = torch.ones(X_SHAPE, dtype=torch.float32, device=device)
    out = []
    for n in sizes:
        sm = torch.arange(n, dtype=torch.int32, device=device)
        try:
            got = smem_probe(sm, x)
        except CudaError as e:
            out.append((n, False, e))
            break
        out.append((n, torch.equal(got, smem_probe_reference(sm, x)), None))
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raytracingc_tpu_torch.tools.smem_probe",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    limit = optin_bytes(device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu, the plain version (no limit); the ladder of an H100")
    print(f"shared memory per block, opt-in maximum: {limit} bytes ({where})",
          flush=True)
    for n, equal, err in run_ladder(device, ladder(limit)):
        size = f"SMEM {n} i32 words ({n * 4} bytes, {n * 4 / 1024:g} KiB)"
        if err is not None:
            print(f"{size}: FAIL {err}", flush=True)
        elif not equal:
            print(f"{size}: FAIL the output differs from the plain version",
                  flush=True)
            return 1
        else:
            print(f"{size}: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
