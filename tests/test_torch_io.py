"""The port's image and scene I/O against the JAX package's on the same
bytes: the Radiance .hdr codec (flat, new-style RLE and old-style RLE
scanlines), the PNG and BMP writers and readers, read_image_float's
dispatch and LDR semantics, the OBJ + MTL parser (the port's native C++
parser and its Python parser against the JAX package's, on faces that
need triangulating, ``v//vn``, negative indices, a face before any
``usemtl``, an unknown material and ``illum 0``), and load_scene's scene
through a one-bounce brute-force frame.

Tolerances: codecs and parsers bit for bit (the same numpy arithmetic);
the frame per pixel within rtol 1e-4 / atol 1e-6
(tests/test_torch_parity.py's per-pixel tolerance).
"""

import struct
import subprocess
import zlib

import jax
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu import native as JN
from sycl_ray_tracing_tpu.models import pathtracer as JP
from sycl_ray_tracing_tpu.models.camera import pbrt_dragon_camera as jax_cam
from sycl_ray_tracing_tpu.utils import hdr as jhdr
from sycl_ray_tracing_tpu.utils import image_io as jio
from sycl_ray_tracing_tpu.utils import obj_loader as jobj
from sycl_ray_tracing_tpu.utils import png as jpng
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu_torch import native
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.ops import rng
from sycl_ray_tracing_tpu_torch.utils import hdr as phdr
from sycl_ray_tracing_tpu_torch.utils import image_io as pio
from sycl_ray_tracing_tpu_torch.utils import obj_loader as pobj
from sycl_ray_tracing_tpu_torch.utils import png as ppng
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.procedural import (
    dragon_scene,
    procedural_sky,
    write_obj,
)
from test_torch_native import JAX_DIR

HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
PARSED_FIELDS = ("triangles", "material_indices", "emissive_indices",
                 "emission", "diffuse", "metalness", "roughness",
                 "material_names")


def _hdr_image(h=16, w=24, seed=7):
    img = np.random.default_rng(seed).uniform(0, 4, (h, w, 3))
    img = img.astype(np.float32)
    img[0, 0] = 0.0                  # an all-zero pixel (exponent 0)
    img[1, 2] = (1e4, 2.0, 0.0)      # high dynamic range in one pixel
    return img


def test_hdr_writers_and_readers_agree(tmp_path):
    img = _hdr_image()
    p, j = tmp_path / "p.hdr", tmp_path / "j.hdr"
    phdr.write_hdr(str(p), img)
    jhdr.write_hdr(str(j), img)
    assert p.read_bytes() == j.read_bytes()
    for flip in (False, True):
        got = phdr.read_hdr(str(p), flip_y=flip)
        np.testing.assert_array_equal(got, jhdr.read_hdr(str(p),
                                                         flip_y=flip))
    # RGBE shares one exponent across channels: a channel's error is at
    # most about 1/256 of the pixel's largest channel
    back = phdr.read_hdr(str(p))
    tol = img.max(axis=-1, keepdims=True) / 128
    assert (np.abs(back - img) <= tol).all()


def _rle_channel(values: np.ndarray) -> bytes:
    """New-style RLE of one channel plane: runs of >= 4 equal bytes as
    (128 + n, v), everything else as literals (n, bytes...)."""
    out, i, n = bytearray(), 0, len(values)
    while i < n:
        j = i
        while j < n and j - i < 127 and values[j] == values[i]:
            j += 1
        if j - i >= 4:
            out += bytes([128 + j - i, int(values[i])])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 3 < n and values[k] == values[k + 1] == values[k + 2]
                == values[k + 3]):
            k += 1
        k = max(k, i + 1)
        out += bytes([k - i]) + bytes(values[i:k].tolist())
        i = k
    return bytes(out)


def test_hdr_new_style_rle(tmp_path):
    """Scanlines in new-style RLE (2, 2, w >> 8, w & 255, then each of the
    four channel planes run-length coded), as stb and Blender write."""
    img = _hdr_image(6, 40)
    img[2, 5:30] = (0.5, 0.25, 0.125)        # runs
    rgbe = jhdr._float_to_rgbe(img)
    h, w = img.shape[:2]
    body = bytearray()
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            body += _rle_channel(rgbe[y, :, c])
    p = tmp_path / "rle.hdr"
    p.write_bytes(HEADER + f"-Y {h} +X {w}\n".encode() + bytes(body))
    got = phdr.read_hdr(str(p))
    np.testing.assert_array_equal(got, jhdr.read_hdr(str(p)))
    np.testing.assert_array_equal(got, jhdr._rgbe_to_float(rgbe))


def test_hdr_old_style_rle(tmp_path):
    """Old-style RLE (stb semantics: (1,1,1,n) repeats the previous pixel
    n << shift times; consecutive markers shift the count by 8 more)."""
    w, h = 12, 3
    px = np.array([128, 64, 32, 136], np.uint8)
    px2 = np.array([20, 200, 90, 135], np.uint8)
    stream = bytes(px) + bytes([1, 1, 1, 11])
    stream += bytes(px2) + bytes([1, 1, 1, 11])
    # 1 literal + (1 << 0) + (1 << 8) repeats, clipped at the image's end
    stream += bytes(px) + bytes([1, 1, 1, 1]) + bytes([1, 1, 1, 1])
    p = tmp_path / "old.hdr"
    p.write_bytes(HEADER + f"-Y {h} +X {w}\n".encode() + stream)
    got = phdr.read_hdr(str(p))
    np.testing.assert_array_equal(got, jhdr.read_hdr(str(p)))
    want = [jhdr._rgbe_to_float(v[None])[0] for v in (px, px2, px)]
    for y in range(h):
        np.testing.assert_array_equal(got[y], np.tile(want[y], (w, 1)))


def test_hdr_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    for read in (phdr.read_hdr, jhdr.read_hdr):
        with pytest.raises(ValueError):
            read(str(bad))
    odd = tmp_path / "odd.hdr"
    odd.write_bytes(HEADER + b"+X 2 -Y 2\n" + bytes(16))
    for read in (phdr.read_hdr, jhdr.read_hdr):
        with pytest.raises(ValueError):
            read(str(odd))


def _ldr(h=9, w=13, c=3, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("flip", [False, True])
def test_png_and_bmp_writers_agree(tmp_path, flip):
    f = np.random.default_rng(5).uniform(-0.2, 1.2, (7, 11, 3))
    for img in (_ldr(), f.astype(np.float32), _ldr(c=1)[..., 0]):
        for port, jax_w, name in ((ppng.write_png, jpng.write_png, "png"),
                                  (ppng.write_bmp, jpng.write_bmp, "bmp")):
            if name == "bmp" and img.ndim == 2:
                continue
            p, j = tmp_path / f"p.{name}", tmp_path / f"j.{name}"
            port(str(p), img, flip_y=flip)
            jax_w(str(j), img, flip_y=flip)
            assert p.read_bytes() == j.read_bytes(), name


def _filtered_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG whose row y uses filter y % 5 (none, sub, up, average,
    paeth), the filters our writer never emits."""
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur, ft = rows[y], y % 5
        left = np.r_[np.zeros(c, np.int32), cur[:-c]]
        upleft = np.r_[np.zeros(c, np.int32), prev[:-c]]
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ft]) + bytes(((cur - pred) & 0xFF).astype(np.uint8))
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_readers_agree_on_every_filter(tmp_path, channels):
    img = _ldr(11, 7, channels)
    p = tmp_path / "f.png"
    p.write_bytes(_filtered_png(img))
    got = pio.read_png(str(p))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jio.read_png(str(p)))
    np.testing.assert_array_equal(ppng.read_png(str(p)),
                                  jpng.read_png(str(p)))
    for flip in (False, True):
        np.testing.assert_array_equal(
            pio.read_image_float(str(p), flip_y=flip),
            jio.read_image_float(str(p), flip_y=flip))


def test_bmp_reader_and_ldr_semantics(tmp_path):
    img = _ldr(5, 6)
    p = tmp_path / "t.bmp"
    ppng.write_bmp(str(p), img, flip_y=False)
    np.testing.assert_array_equal(pio.read_bmp(str(p)), img)
    np.testing.assert_array_equal(pio.read_bmp(str(p)),
                                  jio.read_bmp(str(p)))
    f = pio.read_image_float(str(p))
    # LDR bytes map to [0, 1] by /255 with no gamma change
    np.testing.assert_array_equal(f, img.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(f, jio.read_image_float(str(p)))


def test_read_image_float_hdr_dispatch(tmp_path):
    img = _hdr_image()
    p = tmp_path / "sky.HDR"
    phdr.write_hdr(str(p), img)
    for flip in (False, True):
        got = pio.read_image_float(str(p), flip_y=flip)
        np.testing.assert_array_equal(got, phdr.read_hdr(str(p),
                                                         flip_y=flip))
        np.testing.assert_array_equal(got, jio.read_image_float(
            str(p), flip_y=flip))


OBJ = """# test mesh
mtllib t.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1.25
v 2 0 0
v 3 0 0.5
vn 0 0 1
vt 0 0
f 1 2 3
usemtl red
f 1/1 2/1 3/1 4/1
f 1//1 3//1 4//1
usemtl light
f -1 -2 -3
f 1/1/1 2/1/1 5/1/1 6/1/1 7/1/1
usemtl nowhere
f 2 3 5
usemtl flat
f 1 2 5
usemtl red
f 4 -3 -4
"""

MTL = """newmtl red
Kd 0.8 0.1 0.1
Pm 0.3
Pr 0.005
illum 2
# a light
newmtl light
Kd 0 0 0
Ke 5 5 4
illum 2
newmtl flat
Kd 0.2 0.3 0.4
Pm 0.9
Pr 0.4
illum 0
"""


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's native library built from its own sources (with
    the port's flags), for its C++ OBJ parser."""
    lib = tmp_path_factory.mktemp("jaxlib") / "libsrt_native.so"
    srcs = [str(JAX_DIR / "native" / f) for f in ("bvh_builder.cpp",
                                                  "obj_parser.cpp")]
    subprocess.run(["g++", *native.CXXFLAGS, "-o", str(lib), *srcs],
                   check=True, capture_output=True, timeout=300)
    return str(lib)


@pytest.mark.parametrize("jax_native", [False, True])
def test_obj_parsers_agree_with_jax(tmp_path, monkeypatch, jax_native,
                                    jax_native_lib):
    (tmp_path / "t.obj").write_text(OBJ)
    (tmp_path / "t.mtl").write_text(MTL)
    path = str(tmp_path / "t.obj")
    if jax_native:
        monkeypatch.setattr(JN, "_LIB_PATH", jax_native_lib)
        monkeypatch.setattr(JN, "_lib", None)
        monkeypatch.setattr(JN, "_load_failed", False)
        assert JN.parse_obj_geometry(path) is not None
    want = jobj.parse_obj(path, use_native=jax_native)
    assert want.triangles.shape == (11, 3, 3)
    for use_native in (True, False):
        got = pobj.parse_obj(path, use_native=use_native)
        for f in PARSED_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    # the face before any usemtl and the unknown material take row 0;
    # illum 0 resets roughness/metalness; Pr is clamped at 1e-2
    np.testing.assert_array_equal(
        want.material_indices, [0, 1, 1, 1, 2, 2, 2, 2, 0, 3, 1])
    assert want.roughness[1] == np.float32(1e-2)
    assert (want.metalness[3], want.roughness[3]) == (0.0, 1.0)
    np.testing.assert_array_equal(want.emissive_indices, [4, 5, 6, 7])


def test_native_obj_parser_raises_on_a_missing_file(tmp_path):
    with pytest.raises(OSError):
        pobj.parse_obj(str(tmp_path / "missing.obj"))


def test_load_scene_frame_matches_jax(tmp_path):
    """load_scene of a written OBJ + sky in both packages: the same
    one-bounce brute-force frame per pixel."""
    from sycl_ray_tracing_tpu.utils.obj_loader import load_scene as jax_load

    s = dragon_scene(2_000, with_sky=False, build_accel=False, device="cpu")
    obj = str(tmp_path / "d.obj")
    write_obj(obj, s.triangles, s.material_indices, s.materials)
    sky = procedural_sky(16, 32)
    ps = pobj.load_scene(obj, env_map_image=sky, device="cpu")
    js = jax_load(obj, env_map_image=sky)
    assert ps.device.type == "cpu"
    np.testing.assert_array_equal(ps.triangles.numpy(), s.triangles.numpy())
    np.testing.assert_array_equal(ps.emissive_indices.numpy(),
                                  np.asarray(js.emissive_indices))
    kw = dict(width=8, height=8, samples=1, bounces=1, intersect="brute",
              tile_rays=None, estimator="shared")
    ji = JP.render(js, jax_cam(), JaxConfig(**kw), jax.random.PRNGKey(4))
    with torch.no_grad():
        pi = PP.render(ps, pbrt_dragon_camera("cpu"), RenderConfig(**kw),
                       rng.prng_key(4))
    assert float(pi.mean()) > 1e-3
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-4,
                               atol=1e-6)
