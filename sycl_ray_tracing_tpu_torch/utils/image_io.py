"""Auto LDR/HDR image reading (reference image_io.cpp:96-155 read_image).

The reference dispatches on stbi_is_hdr: Radiance .hdr files decode to
linear floats, everything else (PNG/BMP LDR) decodes to uint8 and is
divided by 255 WITHOUT gamma linearization (the reference leaves the
stbi_ldr_to_hdr conversion as a TODO, image_io.cpp:124-126 — we match the
shipped behavior, not the TODO).  Pure-python decoders; no vendored C.
A copy of sycl_ray_tracing_tpu/utils/image_io.py, kept unchanged in
behaviour.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from sycl_ray_tracing_tpu_torch.utils.hdr import read_hdr


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader -> uint8 [H,W,C] (8-bit gray/RGB/RGBA,
    non-interlaced — the subset our own writer and common tools emit)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    w = h = None
    bitdepth = ctype = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if bitdepth != 8 or interlace != 0:
                raise ValueError(f"{path}: unsupported PNG (depth/interlace)")
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"{path}: unsupported PNG color type {ctype}")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8)
        pos += 1 + stride
        if ftype == 0:
            cur = row.copy()
        elif ftype == 2:  # up
            cur = row + prev
        elif ftype in (1, 3, 4):  # sub / average / paeth need a scan
            cur = np.zeros(stride, np.uint8)
            c = channels
            for i in range(stride):
                a = int(cur[i - c]) if i >= c else 0
                b = int(prev[i])
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    cc = int(prev[i - c]) if i >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cc
                    )
                cur[i] = (int(row[i]) + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, channels)


def read_bmp(path: str) -> np.ndarray:
    """Minimal BMP reader -> uint8 [H,W,3] (24-bit uncompressed)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP")
    (offset,) = struct.unpack("<I", data[10:14])
    w, h = struct.unpack("<ii", data[18:26])
    bpp, comp = struct.unpack("<HI", data[28:34])
    if bpp != 24 or comp != 0:
        raise ValueError(f"{path}: unsupported BMP ({bpp}bpp comp={comp})")
    flip = h > 0
    h = abs(h)
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(
        data[offset : offset + stride * h], np.uint8
    ).reshape(h, stride)[:, : w * 3].reshape(h, w, 3)
    rgb = rows[..., ::-1]  # BGR -> RGB
    if flip:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def read_image_float(path: str, flip_y: bool = False) -> np.ndarray:
    """Auto LDR/HDR read -> float32 [H,W,3] (reference read_image
    dispatch, image_io.cpp:96-155).  LDR bytes map to [0,1] by /255 with
    no gamma change, matching the reference."""
    low = path.lower()
    if low.endswith(".hdr"):
        return read_hdr(path, flip_y=flip_y)
    if low.endswith(".bmp"):
        img = read_bmp(path)
    else:
        img = read_png(path)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    img = img[..., :3].astype(np.float32) / 255.0
    if flip_y:
        img = img[::-1]
    return np.ascontiguousarray(img)
