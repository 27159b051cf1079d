"""ctypes bindings for the native C++ scene loader.

Counterpart of ``raytracingc_tpu/scene/native.py``: the repo's
``native/rtc_loader.cpp`` (the reference's C loader layer, ``objloader.c``
and ``raytracing.c:19-98``) built as a plain shared library and bound with
ctypes. ``load_obj_native`` / ``load_triangles_txt_native`` return the same
numpy arrays as the Python parsers in ``obj_loader.py`` / ``triangles_txt.py``.

The library is compiled by ``g++ -O2 -fPIC -std=c++17 -shared`` through
``ops/_build.py``'s :func:`~raytracingc_tpu_torch.ops._build.build_shared`:
into the port's build directory (``build/raytracingc_tpu_torch/``), never
into ``native/``, under a name that carries a hash of the source and the
flags, written under a temporary name and ``os.replace``-d into place, so
concurrent builds never load a half-written library. :func:`available`
builds it on first use and reports whether that worked (no compiler, no
source: False). This is a host parser under one parse contract, not a
device path.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np

from raytracingc_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "rtc_loader.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_PF = ctypes.POINTER(ctypes.c_float)
_LOAD_ARGS = ([ctypes.c_char_p] + [ctypes.POINTER(_PF)] * 5
              + [ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int])
_SIGNATURES = {
    "rtc_load_obj": (_LOAD_ARGS, ctypes.c_int),
    "rtc_load_triangles_txt": (_LOAD_ARGS, ctypes.c_int),
    "rtc_free": ([_PF], None),
}

_lib: ctypes.CDLL | None = None
build_error = ""  # why the last build failed ("" if it did not)


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return _build.hashed_library("librtc_loader", [SOURCE], CXX_FLAGS)


def build() -> bool:
    """Compile the native library unless it exists; True on success."""
    global build_error
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.is_file():
        build_error = "no g++ on PATH" if cxx is None else f"{SOURCE} is missing"
        return False
    try:
        _build.build_shared(library_path(), lambda tmpdir, tmp: _build.run_all(
            [[cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]]))
    except RuntimeError as e:  # the compiler's refusal, reported by available()
        build_error = str(e)
        return False
    build_error = ""
    return True


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is None and build():
        _lib = _build.bind(library_path(), _SIGNATURES)
    return _lib


def available() -> bool:
    """Whether the native loader is built (building it if it is not)."""
    return _load() is not None


def _call(fn_name: str, path: str):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader not built ({build_error}); use the "
                           "Python parsers in obj_loader / triangles_txt")
    verts, normals, albedo, emission, smooth = _PF(), _PF(), _PF(), _PF(), _PF()
    count = ctypes.c_int(0)
    errbuf = ctypes.create_string_buffer(1024)
    rc = getattr(lib, fn_name)(
        path.encode(), ctypes.byref(verts), ctypes.byref(normals),
        ctypes.byref(albedo), ctypes.byref(emission), ctypes.byref(smooth),
        ctypes.byref(count), errbuf, len(errbuf),
    )
    if rc == 1:
        raise FileNotFoundError(errbuf.value.decode() or path)
    if rc != 0:
        raise ValueError(errbuf.value.decode() or f"{fn_name} failed ({rc})")
    t = count.value

    def take(ptr, n):
        arr = (np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n
               else np.zeros((0,), np.float32))
        lib.rtc_free(ptr)
        return arr.astype(np.float32)

    v = take(verts, 9 * t).reshape(t, 3, 3)
    n = take(normals, 3 * t).reshape(t, 3)
    a = take(albedo, 3 * t).reshape(t, 3)
    e = take(emission, t)
    s = take(smooth, t)
    return v, n, a, e, s


def load_obj_native(path: str):
    """Native OBJ/MTL parse: ``(verts [T, 3, 3], normals, albedo, emission,
    smoothness)``, the contract of ``obj_loader.load_obj``."""
    return _call("rtc_load_obj", path)


def load_triangles_txt_native(path: str):
    """Native triangles.txt parse, the contract of
    ``triangles_txt.load_triangles_txt``."""
    return _call("rtc_load_triangles_txt", path)
