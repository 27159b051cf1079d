"""Image writeback: tonemap and BMP/PNG encoding.

Numpy only: the same code as ``raytracingc_tpu/render/image.py``,
kept in the port because importing any module of the JAX package imports
jax.

The reference tonemaps linear radiance to bytes with a clamp and ×255 — no
gamma correction (``floatToUint``, ``moremath.c:25-30``: negative → 0,
``f >= 1`` → 255, else ``(uint8)(f * 255)`` which truncates) — and writes a
24-bit BMP via the vendored stb writer (``main.c:305``). Here the BMP encoder
is a small self-contained implementation of the standard BITMAPINFOHEADER
format (bottom-up BGR rows, 4-byte row alignment); PNG output goes through the
standard-library ``zlib`` with stored-or-deflate idat, no external deps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap_to_bytes(linear: np.ndarray) -> np.ndarray:
    """Linear [H, W, 3] float → uint8, reference ``floatToUint`` semantics."""
    f = np.asarray(linear, np.float32)
    out = np.where(f >= 1.0, 255, np.trunc(np.maximum(f, 0.0) * 255.0)).astype(np.uint8)
    return out


def bmp_bytes(pixels: np.ndarray) -> bytes:
    """A 24-bit BMP file's bytes. ``pixels`` is [H, W, 3] uint8 RGB, row 0 =
    top."""
    h, w, _ = pixels.shape
    row_bytes = (w * 3 + 3) & ~3
    image_size = row_bytes * h
    file_size = 54 + image_size
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM",
        file_size,
        0,
        0,
        54,  # pixel data offset
        40,  # BITMAPINFOHEADER size
        w,
        h,
        1,  # planes
        24,  # bpp
        0,  # BI_RGB
        image_size,
        2835,  # ~72 DPI
        2835,
        0,
        0,
    )
    bgr = pixels[::-1, :, ::-1]  # bottom-up rows, BGR channel order
    padded = np.zeros((h, row_bytes), np.uint8)
    padded[:, : w * 3] = bgr.reshape(h, w * 3)
    return header + padded.tobytes()


def write_bmp(path: str, pixels: np.ndarray) -> None:
    """Write a 24-bit BMP (:func:`bmp_bytes`)."""
    with open(path, "wb") as fh:
        fh.write(bmp_bytes(pixels))


def read_bmp(path: str) -> np.ndarray:
    """Read a 24-bit uncompressed BMP back to [H, W, 3] uint8 RGB (top-down)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    w, h = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError(f"{path}: only 24-bit BMPs supported (got {bpp})")
    flip = h > 0
    h = abs(h)
    row_bytes = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=row_bytes * h, offset=offset)
    img = rows.reshape(h, row_bytes)[:, : w * 3].reshape(h, w, 3)[:, :, ::-1]
    return img[::-1] if flip else img


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write an RGB8 PNG using zlib only. ``pixels`` is [H, W, 3] uint8."""
    h, w, _ = pixels.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1
    ).tobytes()
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", ihdr))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG back to [H, W, 3] uint8.

    Completes the round-trip with :func:`write_png` (the reference only
    WRITES images, via stb — ``raytracing.c:11-15``; readers exist here so
    golden tests and tooling can consume our own outputs without external
    deps). Supports non-interlaced 8-bit truecolor (the subset
    :func:`write_png` emits) with all five scanline filter types, multiple
    IDAT chunks, and RGBA input (alpha dropped).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if depth != 8 or color not in (2, 6) or interlace != 0:
                raise ValueError(
                    f"{path}: only 8-bit non-interlaced RGB(A) supported "
                    f"(depth={depth}, color={color}, interlace={interlace})"
                )
            nch = 3 if color == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if w == 0:
        raise ValueError(f"{path}: missing or empty IHDR chunk")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = w * nch
    rows = raw.reshape(h, stride + 1)
    filters, scan = rows[:, 0], rows[:, 1:].astype(np.int32)
    if filters.max(initial=0) > 4:
        raise ValueError(
            f"{path}: unknown scanline filter type {int(filters.max())}"
        )
    out = np.zeros((h, stride), np.int32)
    for y in range(h):
        cur = scan[y].copy()
        up = out[y - 1] if y else np.zeros(stride, np.int32)
        f = filters[y]
        if f == 0:
            out[y] = cur
        elif f == 2:  # Up
            out[y] = (cur + up) & 0xFF
        else:  # Sub / Average / Paeth carry a left dependency → scan in x
            row = out[y]
            for x in range(stride):
                a = row[x - nch] if x >= nch else 0
                b = up[x]
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) >> 1
                else:  # Paeth
                    c = up[x - nch] if x >= nch else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (cur[x] + pred) & 0xFF
    return out.astype(np.uint8).reshape(h, w, nch)[:, :, :3]


def read_image(path: str) -> np.ndarray:
    """Dispatch on extension: BMP or PNG → [H, W, 3] uint8."""
    if path.lower().endswith(".png"):
        return read_png(path)
    return read_bmp(path)


def write_image(path: str, pixels: np.ndarray) -> None:
    """Dispatch on extension: .bmp (default, like the reference) or .png."""
    if path.lower().endswith(".png"):
        write_png(path, pixels)
    else:
        write_bmp(path, pixels)
