"""Minimal PNG writer (pure python: zlib + struct) — replaces stb_image_write
(reference image_io.cpp:165-215) without vendored C.  A copy of
sycl_ray_tracing_tpu/utils/png.py, kept unchanged in behaviour.

``write_png`` takes a float image in [0,1] with row 0 at the BOTTOM (the
renderer's framebuffer convention, see models/pathtracer.render) and writes a
top-down PNG, matching how the reference's flipped writes come out on screen.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray, flip_y: bool = True) -> None:
    """Write [H,W,3] float [0,1] (or uint8) as an 8-bit RGB PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if flip_y:
        img = img[::-1]
    h, w = img.shape[:2]

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def write_bmp(path: str, image: np.ndarray, flip_y: bool = True) -> None:
    """Write [H,W,3] float [0,1] (or uint8) as a 24-bit BMP
    (reference image_io.cpp write_image_bmp parity)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if flip_y:
        img = img[::-1]
    h, w = img.shape[:2]
    # BMP stores bottom-up BGR with 4-byte row padding
    row = img[::-1, :, ::-1]
    pad = (-(w * 3)) % 4
    rows = b"".join(
        row[y].tobytes() + b"\x00" * pad for y in range(h)
    )
    size = 54 + len(rows)
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", size, 0, 0, 54,
        40, w, h, 1, 24, 0, len(rows), 2835, 2835, 0, 0,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows)


def read_png(path: str) -> np.ndarray:
    """Tiny PNG reader for round-trip tests (8-bit RGB/RGBA, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", payload[:10])
            assert depth == 8, "only 8-bit PNGs supported"
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        row = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).copy()
        if ftype == 0:
            pass
        elif ftype == 2:  # up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 1:  # sub
            for x in range(channels, stride):
                row[x] = (int(row[x]) + int(row[x - channels])) & 0xFF
        elif ftype == 3:  # average
            for x in range(stride):
                left = int(row[x - channels]) if x >= channels else 0
                row[x] = (int(row[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for x in range(stride):
                a = int(row[x - channels]) if x >= channels else 0
                b = int(prev[x])
                c = int(prev[x - channels]) if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (int(row[x]) + pred) & 0xFF
        out[y] = row
        prev = row
    return out.reshape(h, w, channels)
