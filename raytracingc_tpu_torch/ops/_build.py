"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes``. The library goes into
``build/raytracingc_tpu_torch/`` beside the package (gitignored) under a name
that carries a hash of the sources, the headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds. It is written under a
temporary name and ``os.replace``-d into place, so two processes never load a
half-written library. :func:`hashed_library`, :func:`build_shared` and
:func:`bind` carry that policy for every library the port builds (the native
scene loader's too).

Nothing here runs on import: the library is built on the first kernel launch
on a CUDA device (or by :func:`load_library`), never on the CPU. Every launch
and grid query reaches its card through :func:`card`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "raytracingc_tpu_torch"

# --fmad=false keeps every multiply and add rounded on its own, like PyTorch's
# eager elementwise ops, so a kernel equals its plain version bit for bit.
# Division stays IEEE (no --use_fast_math) and denormals are kept (no ftz).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint

# C signature of each exported function: (argtypes, restype).
_SIGNATURES = {
    "rtc_search_brute": ([_VOID_P] * 4 + [_INT, _INT] + [_VOID_P] * 3, _INT),
    "rtc_search_brute_tris": ([_VOID_P] * 7 + [_INT, _INT] + [_VOID_P] * 3, _INT),
    "rtc_search_brute_parts": ([_INT, _INT], _INT),
    "rtc_search_bitmask": ([_VOID_P] * 5 + [_INT] * 3 + [_VOID_P] * 4, _INT),
    "rtc_search_packed": ([_VOID_P] * 5 + [_INT] * 5 + [_VOID_P] * 3, _INT),
    "rtc_range_items": ([_VOID_P] * 2 + [_INT] * 2 + [_VOID_P] * 4, _INT),
    "rtc_search_range": ([_VOID_P] * 7 + [_INT] * 2 + [_VOID_P] * 3, _INT),
    "rtc_search_range_grid": ([_VOID_P] * 2, _INT),
    "rtc_unpack_keys": ([_VOID_P] * 2 + [_INT] + [_VOID_P] * 3, _INT),
    "rtc_words_items": ([_VOID_P] + [_INT] * 5 + [_VOID_P] * 4, _INT),
    "rtc_search_words": ([_VOID_P] * 6 + [_INT] * 6 + [_VOID_P] * 3, _INT),
    "rtc_search_words_grid": ([_VOID_P] * 2, _INT),
    "rtc_mxu_pack": ([_VOID_P, _INT, _INT, _VOID_P, _VOID_P], _INT),
    "rtc_mxu_items": ([_VOID_P] * 2 + [_INT] * 3 + [_VOID_P] * 4, _INT),
    "rtc_search_mxu": ([_VOID_P] * 7 + [_INT] * 4 + [_VOID_P] * 4, _INT),
    "rtc_search_mxu_grid": ([_INT] + [_VOID_P] * 2, _INT),
    "rtc_smem_probe": ([_VOID_P] * 2 + [_INT] * 2 + [_VOID_P, _INT, _VOID_P], _INT),
    "rtc_smem_set_limit": ([_INT], _INT),
    "rtc_smem_optin": ([_INT, _VOID_P], _INT),
    "rtc_shade_bounce": ([_VOID_P, _INT] + [_VOID_P] * 9 + [_INT] + [_VOID_P] * 7, _INT),
    "rtc_shade_step": ([_VOID_P, _INT] + [_VOID_P] * 12 + [_INT] + [_VOID_P] * 7, _INT),
    "rtc_shade_primary": ([_VOID_P, _INT] + [_VOID_P] * 6 + [_INT] + [_VOID_P] * 8,
                          _INT),
    "rtc_shade_open": ([_UINT, _VOID_P, _VOID_P, _UINT] + [_VOID_P] * 4 + [_INT]
                       + [_VOID_P] * 4, _INT),
    "rtc_cull_words": ([_VOID_P] * 5 + [_INT] * 2 + [_VOID_P] * 2, _INT),
    "rtc_compact": ([_VOID_P, _VOID_P, _INT, _VOID_P, _INT] + [_VOID_P] * 3
                    + [_UINT] * 2 + [_VOID_P] * 3, _INT),
    "rtc_compact_word": ([_VOID_P], _INT),
    "rtc_error_string": ([_INT], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/shared-memory reports) of the last build


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def hashed_library(stem: str, inputs: list[Path], flags) -> Path:
    """``BUILD_DIR/<stem>_<hash>.so``, the hash over the inputs' names and
    bytes and the flags, so an edited input or flag names a new library."""
    h = hashlib.sha256()
    for f in inputs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    return hashed_library("librtc_kernels",
                          _sources() + sorted(SRC_DIR.glob("*.cuh")), NVCC_FLAGS)


def run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands in parallel; ``(cmd, returncode, output)`` each."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    logs = [p.communicate()[0] for _, p in procs]  # waits for each
    return [(cmd, p.returncode, log) for (cmd, p), log in zip(procs, logs)]


def build_shared(out: Path, compile_) -> str:
    """Build the library ``out`` unless it exists; return the compilers'
    output ("" for an existing library).

    ``compile_(tmpdir, tmp)`` runs the compiler commands (through
    :func:`run_all`) in a temporary directory under ``BUILD_DIR``, writing
    the library to the path ``tmp`` in it, and returns their results; ``tmp``
    is then ``os.replace``-d onto ``out``. A failed command raises
    ``RuntimeError`` with its command line and output.
    """
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / out.name
        results = compile_(Path(tmpdir), tmp)
        for cmd, rc, log in results:
            if rc != 0:
                raise RuntimeError(f"{Path(cmd[0]).name} failed ({rc}): "
                                   f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    return "".join(log for _, _, log in results)


def bind(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load the library at ``path`` and set each function's
    ``(argtypes, restype)`` from ``signatures``."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build() -> Path:
    """Compile the sources unless the hashed library already exists."""
    global build_log
    out = library_path()
    nvcc = _nvcc() if not out.exists() else ""

    def compile_(tmpdir: Path, tmp: Path):
        objs = [tmpdir / f"{src.stem}.o" for src in _sources()]
        results = run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        if all(rc == 0 for _, rc, _ in results):
            results += run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                 str(tmp), *map(str, objs)]])
        return results

    build_log = build_shared(out, compile_)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        _lib = bind(build(), _SIGNATURES)
    return _lib


@contextlib.contextmanager
def card(device):
    """``with card(x.device) as (lib, stream):`` the kernel library and the
    raw handle of torch's current stream on ``device``'s card (a
    ``torch.device`` or its name; no index means the current card), for the
    launches and grid queries of one call. The device guard is entered only
    when that card is not the current one."""
    lib = load_library()
    index, current = torch.device(device).index, torch.cuda.current_device()
    if index is None or index == current:
        yield lib, torch._C._cuda_getCurrentRawStream(current)
    else:
        with torch.cuda.device(index):
            yield lib, torch._C._cuda_getCurrentRawStream(index)


def ptxas_report(kernel: str, log: str | None = None) -> str:
    """What ptxas said of the entry functions whose (mangled) name contains
    ``kernel`` in ``log`` (default: the last build's): registers and spill
    bytes, e.g. ``"90 registers, 0 bytes spill stores, 0 bytes spill
    loads"``, one per entry, or "" if the log has none (a cached library)."""
    out, cur = [], None
    for ln in (build_log if log is None else log).splitlines():
        if "Compiling entry function" in ln:
            cur = {} if kernel in ln else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill"] = f"{m.group(1)} bytes spill stores, {m.group(2)} bytes spill loads"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{m.group(1)} registers, {cur.get('spill', 'spills not reported')}")
            cur = None
    return "; ".join(out)


class CudaError(RuntimeError):
    """A C entry point returned a non-zero ``cudaError_t`` (``code``)."""

    def __init__(self, what: str, code: int, msg: str):
        super().__init__(f"{what}: CUDA error {code} ({msg})")
        self.code = code


def check(code: int, what: str) -> None:
    """Raise :class:`CudaError` if a C entry point returned a non-zero
    ``cudaError_t``."""
    if code != 0:
        raise CudaError(what, code, load_library().rtc_error_string(code).decode())
