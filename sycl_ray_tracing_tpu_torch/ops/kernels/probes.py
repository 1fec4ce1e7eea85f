"""The probe kernels: Hopper counterparts of the TPU kernels that the list
tracer's cost-law probes launch (scratch/kernel_shape_bench.py,
micro_copy.py, micro_super.py, pallas_smoke.py, pallas_smoke2.py,
probe_mosaic.py).  No program path calls them; the probe entry point
(``python -m sycl_ray_tracing_tpu_torch.probes``) does.

Kernels (csrc/probes.cu, CUDA C++ for sm_90a, -fmad=false):
  * ``list_tiles_min``: the unguarded per-ray list walk with the lane min
    inside, one t per ray (kernel_shape_bench.py:90), as a union walk:
    a block of LIST_MIN_RAYS rays stages each distinct tile its lists
    name once and tests it for the rays that list it.
  * ``round_probe``: one synthetic list round per variant (tile gather,
    static gather, MT only, both; micro_copy.py:58) and sub-blocks per
    CUDA block (micro_super.py:47), each output starting at ``init``.
  * ``smoke_gather``, ``smoke_rank_select``, ``mosaic_probe``: the Pallas
    feature smoke kernels (pallas_smoke.py:67, pallas_smoke2.py:61,
    probe_mosaic.py:59).  ``smoke_rank_select`` splits its 128 output
    lanes over 32 blocks; each lane's adds stay one chain in ascending
    column order, as in the plain version.
  * ``null_launch`` and ``floor_rung``: an empty kernel and the rungs
    above it (one read of global memory, two dependent ones, one read and
    128 dependent adds), measurement references for the launch floor (no
    TPU kernel, no plain version).
Each wrapper checks its arguments, sends CPU tensors to its plain torch
version beside it, and launches the CUDA kernel for CUDA tensors (or
raises).  ``impl="plain"`` forces the plain version, for comparisons
only.  Launches are counted in ``LAUNCHES``; plain calls are not.
"""

from __future__ import annotations

import ctypes

import torch

from sycl_ray_tracing_tpu_torch.ops.cluster import T_CLUSTER
from sycl_ray_tracing_tpu_torch.ops.kernels import cuda_lib
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
from sycl_ray_tracing_tpu_torch.ops.safe_math import EPS

CSRC = cuda_lib.CSRC_DIR / "probes.cu"

# list_tiles_min's rays (warps) per CUDA block, kMinRays in
# csrc/probes.cu: the fastest of 8 / 16 / 32 on an H100 (PERF.md)
LIST_MIN_RAYS = 8
# lanes of a tile each thread of the redesigned kernels holds
LANES_PER_THREAD = 4

# micro_copy.py / micro_super.py: rays per sub-block, the static tile of
# statcopy; the variants in the C entry point's order
ROUND_RB = 8
STATIC_TILE = 7
ROUND_VARIANTS = ("dyncopy", "statcopy", "mtonly", "dynmt", "dynmt_noeps")
# pallas_smoke.py: rays per grid step, trips of the no-op loop
SMOKE_RT = 64
SMOKE_TRIPS = 4
# probe_mosaic.py: the features and their bits in the C entry point
MOSAIC_FEATURES = {"while": 1, "ds": 2, "extract": 4, "when": 8, "all": 15}
# the rungs of the launch floor's ladder above the empty kernel
FLOOR_RUNGS = {1: "one read", 2: "two dependent reads",
               3: "one read and 128 dependent adds"}

LAUNCHES = {"list_tiles_min": 0, "round_probe": 0, "smoke_gather": 0,
            "smoke_rank_select": 0, "mosaic_probe": 0, "null_launch": 0,
            "floor_rung": 0}

_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_cuda_library() -> ctypes.CDLL:
    """Build csrc/probes.cu with nvcc (at first use, into the package's
    build/ directory) and load it.  Raises if the build fails."""
    global _lib
    if _lib is None:
        from sycl_ray_tracing_tpu_torch.native import build_shared_library

        path = build_shared_library([CSRC], "libprobes",
                                    [cuda_lib.nvcc_path()],
                                    cuda_lib.NVCC_FLAGS, cuda_lib.HEADERS)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, args in (
            ("srt_list_tiles_min", [p] * 4 + [i] * 3 + [p]),
            ("srt_list_tiles_min_info", [i, i, p]),
            ("srt_round_probe", [p] * 3 + [i] * 4 + [f, p]),
            ("srt_round_probe_info", [i, i, p]),
            ("srt_smoke_gather", [p] * 4 + [i, p]),
            ("srt_smoke_rank_select", [p] * 4),
            ("srt_mosaic_probe", [p] * 4 + [i, p]),
            ("srt_null_launch", [p]),
            ("srt_floor_rung", [i] + [p] * 4),
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _use_plain(name: str, impl, *tensors) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs must share a device")
    if impl == "plain" or (impl is None and tensors[0].device.type == "cpu"):
        return True
    if impl not in (None, "cuda"):
        raise ValueError(f"bad impl {impl!r}")
    if not tensors[0].is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors")
    return False


def _check(name: str, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")


def _call(name: str, device, *args):
    """Launch srt_<name> on the device's current stream; raise on a CUDA
    error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(load_cuda_library(), f"srt_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


# ---- list_tiles_min ---------------------------------------------------

def list_tiles_min_plain(cand, rays, tris):
    """Per-ray min over lanes of the per-ray walk's at, over every live
    round: this probe kernel runs no tail guard."""
    return lt._walk(cand, None, rays, tris)[0].amin(dim=1)


def list_tiles_min(cand, rays, tris, impl=None):
    """The per-ray list walk reduced over lanes inside the kernel.
    cand i32 [B, maxc], rays f32 [B, 8], tris f32 [K2+1, 9, 128] ->
    t f32 [B] (the ray's t_lim where nothing is nearer)."""
    lt._check_tile_args(cand, rays, tris, cand.shape[0])
    if _use_plain("list_tiles_min", impl, cand, rays, tris):
        return list_tiles_min_plain(cand, rays, tris)
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned (TMA bulk copy)")
    n = cand.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=cand.device)
    if n:
        _call("list_tiles_min", cand.device, cand.data_ptr(),
              rays.data_ptr(), tris.data_ptr(), out.data_ptr(), n,
              cand.shape[1], tris.shape[0] - 1)
    return out


def list_tiles_min_info(maxc: int, ntiles: int) -> dict:
    """The built union-walk kernel's registers, spill, shared bytes and
    occupancy for lists of ``maxc`` slots over ``ntiles`` (K2+1) tiles."""
    return cuda_lib.kernel_info("list_tiles_min",
                                load_cuda_library().srt_list_tiles_min_info,
                                maxc, ntiles)


# ---- round_probe ------------------------------------------------------

def _synth_mt(p, eps_test: bool):
    """The probes' synthetic Möller–Trumbore (micro_copy.py:35-47) on
    planes p[0..8], in its operation order: the tile's own planes stand
    in for the ray."""
    e1x, e1y, e1z = p[3] - p[0], p[4] - p[1], p[5] - p[2]
    e2x, e2y, e2z = p[6] - p[0], p[7] - p[1], p[8] - p[2]
    hx = e1y * e2z - e1z * e2y
    hy = e1z * e2x - e1x * e2z
    hz = e1x * e2y - e1y * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = torch.reciprocal(torch.where(torch.abs(a) < EPS, 1.0, a))
    u = f * (p[0] * hx + p[1] * hy + p[2] * hz)
    v = f * (p[3] * hx + p[4] * hy + p[5] * hz)
    t = f * (p[6] * hx + p[7] * hy + p[8] * hz)
    ok = (u >= 0) & (v >= 0) & (u + v <= 1)
    if eps_test:
        ok = ok & (t > EPS)
    return torch.where(ok, t, 1e30)


def round_probe_plain(cand, tris, variant: str, init: float = 0.0):
    """Plain version of round_probe: out [rows, 1] f32 from cand i32
    [rows, R] and tris f32 [K, 9, 128], every output starting at
    ``init``; sub-blocks do not change it."""
    rows, rounds = cand.shape
    out = torch.full((rows, 1), init, dtype=torch.float32,
                     device=cand.device)
    if variant == "mtonly":
        # the kernel's stacked tile is zero and never written
        zero = torch.zeros((rows, T_CLUSTER), dtype=torch.float32,
                           device=cand.device)
        planes = [zero] * 9
    for r in range(rounds):
        if variant in ("dyncopy", "dynmt", "dynmt_noeps"):
            tile = tris[cand[:, r].long()]                   # [rows, 9, T]
        elif variant == "statcopy":
            tile = tris[STATIC_TILE].expand(rows, 9, T_CLUSTER)
        if variant in ("dyncopy", "statcopy"):
            out = out + tile[:, 0, 0:1]
            continue
        if variant != "mtonly":
            planes = [tile[:, c, :] for c in range(9)]
        t = _synth_mt(planes, eps_test=variant != "dynmt_noeps")
        out = torch.minimum(out, t.amin(dim=1, keepdim=True))
    return out


def round_probe(cand, tris, variant: str, subblocks: int = 1, impl=None,
                init: float = 0.0):
    """One synthetic list round per variant (see csrc/probes.cu).
    cand i32 [rows, R] (rows a multiple of 8 * subblocks), tris f32
    [K, 9, 128] -> out f32 [rows, 1], every output starting at ``init``
    (the probes' 0; +inf makes the MT variants' output the least t)."""
    if variant not in ROUND_VARIANTS:
        raise ValueError(f"variant must be one of {ROUND_VARIANTS}")
    if cand.dim() != 2 or tris.dim() != 3:
        raise ValueError("cand must be [rows, R] and tris [K, 9, 128]")
    rows, rounds = cand.shape
    _check("cand", cand, torch.int32, (rows, rounds))
    _check("tris", tris, torch.float32, (tris.shape[0], 9, T_CLUSTER))
    if subblocks < 1 or rows % (ROUND_RB * subblocks):
        raise ValueError(f"{rows} rows do not divide into {subblocks} "
                         f"sub-blocks of {ROUND_RB}")
    if rounds < 1 or tris.shape[0] <= STATIC_TILE:
        raise ValueError("need at least one round and 8 tiles")
    if _use_plain("round_probe", impl, cand, tris):
        return round_probe_plain(cand, tris, variant, init)
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned (cp.async)")
    out = torch.empty((rows, 1), dtype=torch.float32, device=cand.device)
    grid = rows // (ROUND_RB * subblocks)
    if grid:
        _call("round_probe", cand.device, cand.data_ptr(), tris.data_ptr(),
              out.data_ptr(), grid, rounds, subblocks,
              ROUND_VARIANTS.index(variant), float(init))
    return out


def round_probe_info(variant: str, subblocks: int = 1) -> dict:
    """The built variant's registers, spill, shared bytes and occupancy
    at ``subblocks`` sub-blocks a block."""
    return cuda_lib.kernel_info("round_probe",
                                load_cuda_library().srt_round_probe_info,
                                ROUND_VARIANTS.index(variant), subblocks)


# ---- smoke_gather -----------------------------------------------------

def smoke_gather_plain(cid, table, rays):
    """rays[:, 0] times the sum over lanes of table[cid[b], 0] (lanes
    added in order) for the 64 rays of each step b, plus 4."""
    nb = cid.shape[0]
    rowv = table[cid.long(), 0, :]                            # [nb, T]
    x = rays[:, 0].view(nb, SMOKE_RT)
    acc = torch.zeros_like(x)
    for lane in range(T_CLUSTER):
        acc = acc + x * rowv[:, lane:lane + 1]
    n = 0.0
    for _ in range(SMOKE_TRIPS):
        n = n + 1.0
    return (acc + n).reshape(-1, 1)


def smoke_gather_args(cid, table, rays, impl=None, check_values=True):
    """smoke_gather's argument checks; True where the plain version
    runs."""
    nb = cid.shape[0] if cid.dim() == 1 else -1
    _check("cid", cid, torch.int32, (nb,))
    _check("table", table, torch.float32, (table.shape[0], 1, T_CLUSTER))
    _check("rays", rays, torch.float32, (nb * SMOKE_RT, 8))
    if nb < SMOKE_TRIPS:
        raise ValueError(f"cid needs at least {SMOKE_TRIPS} entries")
    if check_values:
        if not bool(((cid >= 0) & (cid < table.shape[0])).all()):
            raise ValueError("cid must index rows of table")
    if _use_plain("smoke_gather", impl, cid, table, rays):
        return True
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (16-byte loads)")
    return False


def smoke_gather(cid, table, rays, impl=None, check_values=True):
    """cid i32 [NB] (NB >= 4), table f32 [K, 1, 128], rays f32
    [NB * 64, 8] -> f32 [NB * 64, 1] (pallas_smoke.py:30-46).
    ``check_values=False`` skips the range check of cid, a host read (a
    device sync): for timing the launch alone after a checked call."""
    if smoke_gather_args(cid, table, rays, impl, check_values):
        return smoke_gather_plain(cid, table, rays)
    nb = cid.shape[0]
    out = torch.empty((nb * SMOKE_RT, 1), dtype=torch.float32,
                      device=cid.device)
    _call("smoke_gather", cid.device, cid.data_ptr(), table.data_ptr(),
          rays.data_ptr(), out.data_ptr(), nb)
    return out


# ---- smoke_rank_select ------------------------------------------------

def smoke_rank_select_plain(mask, table):
    """Sum of table[c, 0] over the columns c of mask with any value > 0.5,
    in ascending c."""
    cols = torch.nonzero((mask > 0.5).any(dim=0)).flatten().tolist()
    acc = torch.zeros((1, T_CLUSTER), dtype=torch.float32, device=mask.device)
    for c in cols:
        acc = acc + table[c, 0][None]
    return acc


def smoke_rank_select_args(mask, table, impl=None):
    """smoke_rank_select's argument checks; True where the plain version
    runs."""
    _check("mask", mask, torch.float32, (8, T_CLUSTER))
    _check("table", table, torch.float32, (T_CLUSTER, 1, T_CLUSTER))
    if _use_plain("smoke_rank_select", impl, mask, table):
        return True
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (16-byte loads)")
    return False


def smoke_rank_select(mask, table, impl=None):
    """mask f32 [8, 128], table f32 [128, 1, 128] -> f32 [1, 128]
    (pallas_smoke2.py:24-51)."""
    if smoke_rank_select_args(mask, table, impl):
        return smoke_rank_select_plain(mask, table)
    out = torch.empty((1, T_CLUSTER), dtype=torch.float32, device=mask.device)
    _call("smoke_rank_select", mask.device, mask.data_ptr(), table.data_ptr(),
          out.data_ptr())
    return out


# ---- mosaic_probe -----------------------------------------------------

def mosaic_probe_plain(ns, cand, x, feature: str):
    """probe_mosaic.py's kernel for one feature, in its operation order."""
    f = MOSAIC_FEATURES[feature]
    o = torch.zeros_like(x)
    acc = x.clone()
    n_rounds = int(ns[0])

    def round_body(r: int) -> bool:
        nonlocal o, acc
        col = x[:, r:r + 1] if f & 2 else x[:, 0:1] + float(r)
        if f & 8:
            acc = torch.where(cand[:, r:r + 1] > 0, acc * 1.0001, acc)
        if f & 4:
            if float(col[3, 0] + 1.0) > 0.0:
                o = o + acc
        else:
            o = o + acc + col
        return bool(col.amax() > -1.0)

    if f & 1:
        r, go = 0, n_rounds > 0
        while go:
            ok = round_body(r)
            r += 1
            go = r < n_rounds and ok
    else:
        for r in range(4):
            round_body(r)
    return o


def mosaic_probe_args(ns, cand, x, feature: str, impl=None,
                      check_values=True):
    """mosaic_probe's argument checks; True where the plain version
    runs."""
    if feature not in MOSAIC_FEATURES:
        raise ValueError(f"feature must be one of {tuple(MOSAIC_FEATURES)}")
    _check("ns", ns, torch.int32, (1,))
    _check("cand", cand, torch.int32, (8, T_CLUSTER))
    _check("x", x, torch.float32, (8, T_CLUSTER))
    if check_values and int(ns[0]) > T_CLUSTER:
        raise ValueError("ns[0] counts rounds over the 128 columns")
    if _use_plain("mosaic_probe", impl, ns, cand, x):
        return True
    if cand.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("cand and x must be 16-byte aligned (16-byte "
                         "loads)")
    return False


def mosaic_probe(ns, cand, x, feature: str, impl=None, check_values=True):
    """ns i32 [1] (ns[0] <= 128), cand i32 [8, 128], x f32 [8, 128] ->
    f32 [8, 128], for one probe_mosaic.py feature: while, ds, extract,
    when or all.  ``check_values=False`` skips the check of ns[0], a host
    read (a device sync): for timing the launch alone after a checked
    call."""
    if mosaic_probe_args(ns, cand, x, feature, impl, check_values):
        return mosaic_probe_plain(ns, cand, x, feature)
    out = torch.empty_like(x)
    _call("mosaic_probe", ns.device, ns.data_ptr(), cand.data_ptr(),
          x.data_ptr(), out.data_ptr(), MOSAIC_FEATURES[feature])
    return out


# ---- null_launch and the floor's ladder -------------------------------

def null_launch(device):
    """Launch the empty kernel once on the device's current stream: the
    measurement reference for one launch's floor.  It computes nothing, so
    it has no plain version: a device that is not CUDA raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("null_launch: the empty kernel needs a CUDA device")
    _call("null_launch", device)


def floor_rung(rung: int, idx, src, out):
    """Launch rung ``rung`` of the floor's ladder (FLOOR_RUNGS) once: idx
    i32 [1] names a row of src f32 [rows, 128]; writes out f32 [128].  A
    measurement reference like null_launch: no plain version, and tensors
    off a CUDA device raise."""
    if rung not in FLOOR_RUNGS:
        raise ValueError(f"rung must be one of {tuple(FLOOR_RUNGS)}")
    _check("idx", idx, torch.int32, (1,))
    _check("src", src, torch.float32, (src.shape[0], T_CLUSTER))
    _check("out", out, torch.float32, (T_CLUSTER,))
    if not (idx.is_cuda and src.is_cuda and out.is_cuda):
        raise ValueError("floor_rung: the ladder needs CUDA tensors")
    _call("floor_rung", src.device, rung, idx.data_ptr(), src.data_ptr(),
          out.data_ptr())
