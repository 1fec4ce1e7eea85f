"""Radiance RGBE (.hdr) codec — pure numpy reader/writer (a copy of
sycl_ray_tracing_tpu/utils/hdr.py, kept unchanged in behaviour).

Replaces the reference's stbi_loadf/stbi_write_hdr path (utils.cpp:100-124,
image_io.cpp:165-215) without vendored C.  Supports the -Y H +X W raster
orientation and both RLE and flat scanlines, which covers stb-written and
Blender/PolyHaven HDRs.  ``read_hdr(flip_y=True)`` mirrors the reference's
stbi_set_flip_vertically_on_load for env maps (utils.cpp:102).
"""

from __future__ import annotations

import re

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[...,4] uint8 RGBE -> [...,3] float32."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        e[..., None] == 0, 0.0, 1.0
    )


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[...,3] float32 -> [...,4] uint8 RGBE."""
    rgb = np.maximum(rgb, 0.0).astype(np.float32)
    maxc = rgb.max(axis=-1)
    rgbe = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, expo = np.frexp(np.where(nz, maxc, 1.0))
    scale = mant * 256.0 / np.where(nz, maxc, 1.0)
    mapped = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., :3] = np.where(nz[..., None], mapped, 0)
    rgbe[..., 3] = np.where(nz, expo + 128, 0).astype(np.uint8)
    return rgbe


def read_hdr(path: str, flip_y: bool = False) -> np.ndarray:
    """Read a Radiance .hdr file -> float32 [H,W,3] linear radiance."""
    with open(path, "rb") as f:
        data = f.read()

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")

    # header ends at blank line; next line is the resolution string
    header_end = data.find(b"\n\n")
    if header_end < 0:
        raise ValueError(f"{path}: malformed HDR header")
    res_end = data.find(b"\n", header_end + 2)
    res_line = data[header_end + 2 : res_end].decode("ascii", "replace")
    m = re.match(r"-Y (\d+) \+X (\d+)", res_line)
    if not m:
        raise ValueError(f"{path}: unsupported raster orientation {res_line!r}")
    h, w = int(m.group(1)), int(m.group(2))

    buf = np.frombuffer(data[res_end + 1 :], np.uint8)
    out = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (
            pos + 4 <= len(buf)
            and buf[pos] == 2
            and buf[pos + 1] == 2
            and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == w
            and w >= 8
            and w < 32768
        ):
            pos += 4
            # new-style RLE: 4 separately run-length-coded channel planes
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[pos])
                    pos += 1
                    if count > 128:  # run
                        out[y, x : x + count - 128, c] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        out[y, x : x + count, c] = buf[pos : pos + count]
                        pos += count
                        x += count
        else:
            row = buf[pos : pos + w * 4].reshape(-1, 4)
            markers = (
                (row[:, 0] == 1) & (row[:, 1] == 1) & (row[:, 2] == 1)
            )
            if not markers.any():
                # flat scanline
                out[y] = row
                pos += w * 4
            else:
                # old-style RLE (stbi semantics, utils.cpp:100-124 via
                # stb_image): a (1,1,1,n) pixel repeats the previous pixel
                # n << shift times; consecutive markers bump shift by 8
                flat = out.reshape(-1, 4)
                i = y * w
                end = h * w
                shift = 0
                prev = np.zeros(4, np.uint8)
                while i < end and pos + 4 <= len(buf):
                    px = buf[pos : pos + 4]
                    pos += 4
                    if px[0] == 1 and px[1] == 1 and px[2] == 1:
                        n = int(px[3]) << shift
                        n = min(n, end - i)
                        flat[i : i + n] = prev
                        i += n
                        shift += 8
                    else:
                        flat[i] = px
                        prev = px
                        i += 1
                        shift = 0
                break

    img = _rgbe_to_float(out)
    if flip_y:
        img = img[::-1]
    return np.ascontiguousarray(img)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write float32 [H,W,3] as an uncompressed Radiance .hdr."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    rgbe = _float_to_rgbe(image[..., :3])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode("ascii"))
        f.write(rgbe.tobytes())
