"""The list tracer: exact traversal over precomputed nearest-first
candidate-cluster lists (counterpart of
sycl_ray_tracing_tpu/ops/pallas/listtrace.py).

Host side (torch): root-box cull, one packed [B,8] ray row array, a
STABLE spatial sort, the exact candidate build (ops/cluster.py: the dense
build, or above 2*maxs*64 clusters the supercluster-prefiltered one), one
kernel launch over the live prefix of blocks, and the reduction tail with
its tie rule and the distance + membership certificates (``_run_once``);
then the compacted per-ray escalation pass, always on the dense build,
and the honest overflow flag (``_run``).

Kernels (csrc/listtrace.cu, CUDA C++ for sm_90a), both with the tail
guard of ``_tail_guard``: after GROUP rounds, before each CHUNK of rounds
below the list's count, a list stops once no ray of it can still gain
(the usefulness guard and the any-hit exit); each returns where it
stopped (``stop``, maxc if never):
  * ``block_tiles`` replaces ``_block_kernel_impl``: one list per block of
    RB_SHARE=32 sorted rays; it runs the primaries and every fused bounce
    query.
  * ``list_tiles`` replaces ``_list_kernel_impl``: each ray walks its own
    list, and the guard is per ray (the TPU gated an 8-ray block on its
    max count and on "any ray useful"), so the outputs do not depend on
    ``rays_per_block``; it runs the escalation pass (one ray per CUDA
    block; the probes also run 8, 16 and 32, the TPU kernel's RB).
The guard keeps a closest-hit ray's (t, packed, resolved) exact.  An
any-hit ray that is already blocked may keep a farther hit than the
nearest, as on the TPU (listtrace.py:929-932); its callers read only
``packed >= 0``.
Each wrapper sends CPU tensors to its plain torch version, beside it in
this module, and launches the CUDA kernel for CUDA tensors (or raises).
``impl="plain"`` forces the plain version, for comparisons only.

Left out (outputs do not depend on them): the Mosaic-only details (8-row
SMEM padding, VMEM limits, ``lax.switch`` bucket widths — the port runs
only the live prefix of blocks, a dynamic shape), and the scratch switch
LISTTRACE_NO_ESCALATE.
"""

from __future__ import annotations

import torch

from sycl_ray_tracing_tpu_torch.ops.cluster import (
    S_CLUSTER,
    SHADOW_EPS,
    T_CLUSTER,
    ClusterScene,
    candidate_clusters,
    candidate_clusters_grouped,
    candidate_clusters_hier,
    inv_dir,
)
from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T, Hit, finalize_hit
from sycl_ray_tracing_tpu_torch.ops.kernels.cuda_lib import (
    kernel_info,
    load_cuda_library,
    stream_of,
)
from sycl_ray_tracing_tpu_torch.ops.safe_math import EPS
from sycl_ray_tracing_tpu_torch.utils.metrics import host_read, span

RB = 8             # per-ray pass: rays per sort block
RB_SHARE = 32      # block-shared kernel: rays sharing one candidate list
DEFAULT_MAXC = 32  # per-ray candidate slots
DEFAULT_MAXC_SHARE = 128  # block-union slots
ESC_CAP_DIV = 4    # escalation compaction: cap ~= B/4 rows (>= 256)
HIER_MAXS = 16     # supercluster slots per block in the hierarchical build
GROUP = 8          # rounds before the first tail guard
CHUNK = 16         # rounds between tail guards
MAX_CLUSTERS = 8192  # 13-bit candidate ids / 20-bit packed winners
LIST_SHARE_DEFAULT = True
LIST_RAYS_PER_BLOCK = (1, 8, 16, 32)

# launches of each CUDA kernel since the last reset (plain-version calls
# are not counted)
LAUNCHES = {"block_tiles": 0, "list_tiles": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mt8(ax, ay, az, bx, by, bz, cx, cy, cz, ox, oy, oz, dx, dy, dz, tl):
    """Möller–Trumbore in _mt8's exact operation order (listtrace.py:
    165-194): t of a valid hit below ``tl``, else BIG_T.  Operands
    broadcast against each other."""
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = torch.abs(a) < EPS
    # IEEE reciprocal, the kernel's 1.0f / a
    f = torch.reciprocal(torch.where(parallel, 1.0, a))
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
        & (t < tl)
    )
    return torch.where(ok, t, BIG_T)


def _live_rounds(cand, dummy: int) -> int:
    """Rounds up to the last column holding a real candidate: the rounds
    after it are all dummy tiles, which never update."""
    cols = torch.nonzero((cand != dummy).any(dim=0))
    return int(cols[-1]) + 1 if cols.numel() else 0


def list_counts(cand, dummy: int):
    """Per list: one past its last real slot (0 if it has none).  The exact
    builds fill a list's real slots first, so this is its candidate count,
    the TPU kernel's count gate."""
    slot = torch.arange(1, cand.shape[1] + 1, dtype=torch.int32,
                        device=cand.device)
    return torch.where(cand != dummy, slot, 0).amax(dim=1)


def _walk(cand, ctn, rays, tris):
    """The plain list walk shared by both kernels' plain versions: a loop
    over rounds of _mt8 on [lists, rays per list, 128] tensors, every ray
    of a list against the list's tile of the round.  With ``ctn`` the
    tail guard runs as a per-list active mask updated before each chunk
    (c0 = GROUP + k*CHUNK below the list's count): a list stops at c0
    when none of its rays is useful, i.e. ctn[c0] < best (min over lanes)
    and not an any-hit ray already blocked (best < t_lim).  A stopped list
    runs the dummy tile, which never updates.  ``ctn=None`` walks every
    live round.  Returns (at, ar [rays, 128], stop [lists])."""
    nl, maxc = cand.shape
    dummy = tris.shape[0] - 1
    r = rays.view(nl, -1, 8)
    ox, oy, oz, dx, dy, dz, tl = (r[:, :, c:c + 1] for c in range(7))
    at = tl.expand(nl, r.shape[1], T_CLUSTER).clone()
    ar = torch.full_like(at, -1, dtype=torch.int32)
    anyhit, tlim = r[:, :, 7] > 0.0, r[:, :, 6]
    count = list_counts(cand, dummy)
    stop = torch.full((nl,), maxc, dtype=torch.int32, device=cand.device)
    active = torch.ones((nl,), dtype=torch.bool, device=cand.device)
    for rnd in range(_live_rounds(cand, dummy)):
        if ctn is not None and rnd >= GROUP and (rnd - GROUP) % CHUNK == 0:
            bt = at.amin(dim=2)                          # [lists, rays]
            useful = (ctn[:, rnd:rnd + 1] < bt) & ~(anyhit & (bt < tlim))
            fire = active & (rnd < count) & ~useful.any(dim=1)
            stop = torch.where(fire, rnd, stop)
            active = active & ~fire
        tile = tris[torch.where(active, cand[:, rnd], dummy).long()]
        planes = [tile[:, c:c + 1, :] for c in range(9)]
        t = _mt8(*planes, ox, oy, oz, dx, dy, dz, tl)
        upd = t < at
        at = torch.where(upd, t, at)
        ar = torch.where(upd, rnd, ar)
    return at.view(-1, T_CLUSTER), ar.view(-1, T_CLUSTER), stop


def block_tiles_plain(cand, ctn, rays, tris):
    """Plain torch version of the block-shared kernel: the guarded walk
    with RB_SHARE rays per list.  Returns (at, ar, stop)."""
    return _walk(cand, ctn, rays, tris)


def list_tiles_plain(cand, ctn, rays, tris):
    """Plain torch version of the per-ray kernel: the guarded walk with one
    ray per list, so each ray runs its own guard.  Returns (at, ar,
    stop)."""
    return _walk(cand, ctn, rays, tris)


def _check_tile_args(cand, rays, tris, rows: int, ctn=None):
    if cand.dtype != torch.int32 or rays.dtype != torch.float32 \
            or tris.dtype != torch.float32:
        raise TypeError("cand must be int32, rays and tris float32")
    if not (cand.is_contiguous() and rays.is_contiguous()
            and tris.is_contiguous()):
        raise ValueError("cand, rays and tris must be contiguous")
    if cand.dim() != 2 or not 1 <= cand.shape[1] <= 128:
        raise ValueError(f"cand must be [n, maxc<=128], got {tuple(cand.shape)}")
    if rays.shape != (rows, 8):
        raise ValueError(f"rays must be [{rows}, 8], got {tuple(rays.shape)}")
    if tris.dim() != 3 or tris.shape[1:] != (9, T_CLUSTER):
        raise ValueError(f"tris must be [K2+1, 9, 128], got {tuple(tris.shape)}")
    if not (cand.device == rays.device == tris.device):
        raise ValueError("cand, rays and tris must share a device")
    if ctn is not None and (
            ctn.dtype != torch.float32 or ctn.shape != cand.shape
            or not ctn.is_contiguous() or ctn.device != cand.device):
        raise ValueError("ctn must be contiguous float32 shaped like cand, "
                         "on cand's device")


def _use_plain(name: str, cand, impl) -> bool:
    if impl == "plain" or (impl is None and cand.device.type == "cpu"):
        return True
    if impl not in (None, "cuda"):
        raise ValueError(f"bad impl {impl!r}")
    if not cand.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors")
    return False


def block_tiles(cand, ctn, rays, tris, impl=None):
    """Block-shared list kernel with the tail guard.  cand i32 [nb, maxc]
    (dummy id K2 = tris.shape[0]-1 marks empty slots), ctn f32 [nb, maxc]
    entry-t (ascending along a list), rays f32 [nb*32, 8] (o3 d3 t_lim
    anyhit), tris f32 [K2+1, 9, 128] -> (at f32, ar i32 [nb*32, 128],
    stop i32 [nb]: the first round a block did not run, maxc if its guard
    never fired)."""
    _check_tile_args(cand, rays, tris, cand.shape[0] * RB_SHARE, ctn)
    if _use_plain("block_tiles", cand, impl):
        return block_tiles_plain(cand, ctn, rays, tris)
    return block_tiles_cuda(cand, ctn, rays, tris)


def block_tiles_cuda(cand, ctn, rays, tris):
    """Launch the block kernel, its grid taking the lists longest first
    (sorted on the card).  Arguments as block_tiles, already checked."""
    if not cand.is_cuda:
        raise ValueError("block_tiles: the CUDA kernel needs CUDA tensors")
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned (cp.async)")
    lib = load_cuda_library()
    nb, maxc = cand.shape
    dummy = tris.shape[0] - 1
    at = torch.empty((nb * RB_SHARE, T_CLUSTER), dtype=torch.float32,
                     device=cand.device)
    ar = torch.empty_like(at, dtype=torch.int32)
    stop = torch.empty((nb,), dtype=torch.int32, device=cand.device)
    if nb == 0:
        return at, ar, stop
    # the per-list counts, the launch order and the count histogram
    scratch = torch.empty((2 * nb + maxc + 1,), dtype=torch.int32,
                          device=cand.device)
    rc = lib.srt_block_tiles(
        cand.data_ptr(), ctn.data_ptr(), rays.data_ptr(), tris.data_ptr(),
        scratch.data_ptr(), at.data_ptr(), ar.data_ptr(), stop.data_ptr(),
        nb, maxc, dummy, stream_of(cand))
    if rc != 0:
        raise RuntimeError(f"block_tiles launch failed: CUDA error {rc}")
    LAUNCHES["block_tiles"] += 1
    return at, ar, stop


def block_tiles_info() -> dict:
    """The built block kernel's registers, spill and occupancy."""
    return kernel_info("block_tiles",
                       load_cuda_library().srt_block_tiles_info)


def list_tiles(cand, ctn, rays, tris, impl=None, rays_per_block: int = 1):
    """Per-ray list kernel with a tail guard per ray.  cand i32 [B, maxc]
    (dummy id K2 = tris.shape[0]-1 marks empty slots), ctn f32 [B, maxc]
    entry-t (ascending along a list), rays f32 [B, 8] (o3 d3 t_lim
    anyhit), tris f32 [K2+1, 9, 128] -> (at f32, ar i32 [B, 128], stop
    i32 [B]: the first round a ray did not run, maxc if its guard never
    fired).  ``rays_per_block`` (1, 8, 16 or 32) rays share a CUDA block;
    the main path uses 1.  The outputs do not depend on it, so the plain
    version ignores it."""
    _check_tile_args(cand, rays, tris, cand.shape[0], ctn)
    if rays_per_block not in LIST_RAYS_PER_BLOCK:
        raise ValueError(f"rays_per_block must be one of "
                         f"{LIST_RAYS_PER_BLOCK}, got {rays_per_block}")
    if _use_plain("list_tiles", cand, impl):
        return list_tiles_plain(cand, ctn, rays, tris)
    return list_tiles_cuda(cand, ctn, rays, tris, rays_per_block)


def _list_outputs(n: int, device):
    """Empty (at f32 [n, 128], ar i32 [n, 128], stop i32 [n])."""
    at = torch.empty((n, T_CLUSTER), dtype=torch.float32, device=device)
    ar = torch.empty((n, T_CLUSTER), dtype=torch.int32, device=device)
    stop = torch.empty((n,), dtype=torch.int32, device=device)
    return at, ar, stop


def list_tiles_cuda(cand, ctn, rays, tris, rays_per_block: int = 1):
    """Launch the per-ray kernel's instance for ``rays_per_block``.
    Arguments as list_tiles, already checked."""
    if not cand.is_cuda:
        raise ValueError("list_tiles: the CUDA kernel needs CUDA tensors")
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned (cp.async)")
    lib = load_cuda_library()
    n, maxc = cand.shape
    at, ar, stop = _list_outputs(n, cand.device)
    if n == 0:
        return at, ar, stop
    rc = lib.srt_list_tiles(
        cand.data_ptr(), ctn.data_ptr(), rays.data_ptr(), tris.data_ptr(),
        at.data_ptr(), ar.data_ptr(), stop.data_ptr(), n, maxc,
        tris.shape[0] - 1, rays_per_block, stream_of(cand))
    if rc != 0:
        raise RuntimeError(f"list_tiles launch failed: CUDA error {rc}")
    LAUNCHES["list_tiles"] += 1
    return at, ar, stop


def list_tiles_info(rays_per_block: int = 1) -> dict:
    """The built per-ray kernel's registers, spill and occupancy at
    ``rays_per_block``."""
    if rays_per_block not in LIST_RAYS_PER_BLOCK:
        raise ValueError(f"rays_per_block must be one of "
                         f"{LIST_RAYS_PER_BLOCK}, got {rays_per_block}")
    return kernel_info("list_tiles",
                       load_cuda_library().srt_list_tiles_info,
                       rays_per_block)


def _scene_bounds(scene: ClusterScene):
    return scene.sc_box[:, 0:3].amin(dim=0), scene.sc_box[:, 3:6].amax(dim=0)


def _ray_sort_key(scene: ClusterScene, ray_o, ray_d):
    """Spatial sort key: 15-bit Morton of the origin cell (5 bits/axis over
    the scene bounds) above a 12-bit Morton of the direction (4 bits/axis
    over [-1,1]) (listtrace.py:355-381)."""
    lo, hi = _scene_bounds(scene)
    q = torch.clamp((ray_o - lo) / torch.clamp_min(hi - lo, 1e-6), 0.0, 1.0)
    cell = (q * 31.0).to(torch.int32)                         # [B,3]
    m = torch.zeros(ray_o.shape[:1], dtype=torch.int32, device=ray_o.device)
    for b in range(5):
        for a in range(3):
            m = m | (((cell[:, a] >> b) & 1) << (3 * b + a))
    dq = (torch.clamp(ray_d * 0.5 + 0.5, 0.0, 1.0) * 15.0).to(torch.int32)
    dm = torch.zeros_like(m)
    for b in range(4):
        for a in range(3):
            dm = dm | (((dq[:, a] >> b) & 1) << (3 * b + a))
    return (m << 12) | dm


def _tiles_with_dummy(scene: ClusterScene):
    k2 = scene.num_clusters
    return torch.cat([
        scene.cl_tris.view(k2, 9, T_CLUSTER),
        torch.zeros((1, 9, T_CLUSTER), dtype=torch.float32,
                    device=scene.cl_tris.device),      # dummy: never hits
    ])


def _run_once(scene: ClusterScene, ray_o, ray_d, t_lim, maxc: int, any_hit,
              sort=True, mask=None, share=False, force_dense=False,
              impl=None):
    """ONE exact candidate build + list kernel + reduction tail
    (listtrace.py:384-677), under the span ``query.pass``.  Returns (t
    [B], packed winner cluster*T+lane [B] (-1 miss), resolved [B]).

    ``any_hit``: bool or [B] bool.  ``mask``: optional [B] bool; False rays
    are dead and reported as misses.  Live rays sort ahead of dead ones,
    so only the live prefix of blocks is built and launched.

    Scenes above 2*maxs*64 clusters (maxs = max(HIER_MAXS, maxc // 3)
    superclusters a block) take the supercluster-prefiltered build
    (listtrace.py:474-520), whose SC-overflow rows come poisoned (last
    ctn -BIG_T, so unresolved); ``force_dense`` (the escalation pass)
    keeps the dense build over all K2 clusters."""
    with span("query.pass", rays=ray_o.shape[0]):
        return _pass(scene, ray_o, ray_d, t_lim, maxc, any_hit, sort, mask,
                     share, force_dense, impl)


def _pass(scene, ray_o, ray_d, t_lim, maxc, any_hit, sort, mask, share,
          force_dense, impl):
    if maxc > 128:
        raise ValueError("winner packing uses at most 7 round bits")
    rslot = 1 << max(1, maxc - 1).bit_length()
    B = ray_o.shape[0]
    dev = ray_o.device
    rb = RB_SHARE if share else RB
    nb = -(-B // rb)
    k2 = scene.num_clusters
    maxs = max(HIER_MAXS, maxc // 3)
    big = not force_dense and k2 > 2 * maxs * S_CLUSTER
    # root-box cull: rays missing the scene box join the dead set
    lo, hi = _scene_bounds(scene)
    inv = inv_dir(ray_d)
    t0r = (lo[None] - ray_o) * inv
    t1r = (hi[None] - ray_o) * inv
    tnr = torch.minimum(t0r, t1r).amax(dim=-1)
    tfr = torch.maximum(t0r, t1r).amin(dim=-1)
    root_hit = (tnr <= tfr) & (tfr > EPS) & (tnr < t_lim)
    mask = root_hit if mask is None else (mask & root_hit)
    t_lim = torch.where(mask, t_lim, -BIG_T)
    if isinstance(any_hit, bool):
        ah = torch.full((B,), 1.0 if any_hit else 0.0, dtype=torch.float32,
                        device=dev)
    else:
        ah = any_hit.to(torch.float32)
    # one packed [B,8] row array: o3 d3 t_lim anyhit
    rays = torch.cat([ray_o, ray_d, t_lim[:, None], ah[:, None]], dim=1)
    perm = None
    g = nb
    if sort and B >= 4 * rb:
        key = torch.where(mask, _ray_sort_key(scene, ray_o, ray_d), 1 << 28)
        perm = torch.argsort(key, stable=True)
        rays = rays[perm]
        # live rays sort first: blocks past the live prefix are all dead
        g = -(-host_read("live_rays", mask.sum()) // rb)
    pad = nb * rb - B
    if pad:
        rays = torch.cat([rays, torch.zeros((pad, 8), dtype=rays.dtype,
                                            device=dev)])
    rg = rays[: g * rb].contiguous()
    t = torch.full((nb * rb,), BIG_T, dtype=torch.float32, device=dev)
    packed = torch.full((nb * rb,), -1, dtype=torch.int32, device=dev)
    resolved = torch.ones((nb * rb,), dtype=torch.bool, device=dev)
    if g:
        tris = _tiles_with_dummy(scene)
        args = (scene, rg[:, 0:3], rg[:, 3:6], rg[:, 6], maxc)
        # every pass asks for exact extraction (JAX _run passes exact=True,
        # listtrace.py:746, :780): full rows keep their certificates
        with span("query.build"):
            if share and big:
                cand, ctn, _of, covered = candidate_clusters_hier(
                    *args, maxs, rb, grouped=True, exact=True,
                    ray_cert=True, impl=impl)
            elif share:
                cand, ctn, _of, covered = candidate_clusters_grouped(
                    *args, rb, exact=True, ray_cert=True)
            elif big:
                cand, ctn, _of = candidate_clusters_hier(*args, maxs, rb,
                                                         exact=True)
            else:
                cand, ctn, _of = candidate_clusters(*args, exact=True)
        cand_k = torch.where(cand >= 0, cand, k2).to(torch.int32)
        if share:
            with span("query.kernel", kernel="block_tiles"):
                at, ar, _stop = block_tiles(cand_k.contiguous(), ctn, rg,
                                            tris, impl=impl)
        else:
            with span("query.kernel", kernel="list_tiles"):
                at, ar, _stop = list_tiles(cand_k.contiguous(), ctn, rg,
                                           tris, impl=impl)

        # reduction tail: per-ray min over lanes; among lanes at the min
        # the smallest lane wins, then that lane's round (lane-major pack)
        tlg = rg[:, 6]
        tmin = at.amin(dim=1)
        hit = tmin < tlg
        lanes = torch.arange(T_CLUSTER, dtype=torch.int32, device=dev)
        sel = at <= tmin[:, None]
        pk = torch.where(sel, lanes * rslot + torch.clamp_max(ar, rslot - 1),
                         1 << 30).amin(dim=1)
        lane = torch.div(pk, rslot, rounding_mode="floor")
        rwin = torch.clamp_max(torch.remainder(pk, rslot), maxc - 1)
        if share:
            # distance certificate: best <= last kept entry-t proves no
            # dropped cluster could hold a nearer hit; the per-ray
            # membership certificate covers full blocks
            last_c = cand[:, maxc - 1].repeat_interleave(rb)
            last_t = ctn[:, maxc - 1].repeat_interleave(rb)
            res = (last_c < 0) | (tmin <= last_t) | covered
            blk = torch.arange(g * rb, device=dev) // rb
            cl = cand.reshape(-1)[blk * maxc + rwin]
        else:
            res = (cand[:, maxc - 1] < 0) | (tmin <= ctn[:, maxc - 1])
            cl = torch.gather(cand, 1, rwin[:, None].long())[:, 0]
        # in place: fill the live prefix of the all-miss outputs
        packed[: g * rb] = torch.where(hit, cl * T_CLUSTER + lane, -1)
        t[: g * rb] = torch.where(hit, tmin, BIG_T)
        resolved[: g * rb] = res
    t, packed, resolved = t[:B], packed[:B], resolved[:B]
    if perm is not None:
        # undo the sort: row j of the sorted batch is original row perm[j]
        out_t, out_p, out_r = (torch.empty_like(x) for x in
                               (t, packed, resolved))
        out_t[perm], out_p[perm], out_r[perm] = t, packed, resolved
        t, packed, resolved = out_t, out_p, out_r
    return t, packed, resolved


def _certain(any_hit, packed, resolved):
    """Certain: the certificate holds, or (any-hit rays) a hit below t_lim
    was found, which proves "blocked" regardless of dropped clusters."""
    return resolved | (any_hit & (packed >= 0))


def _run(scene: ClusterScene, ray_o, ray_d, t_lim, maxc: int, any_hit,
         sort=True, mask=None, share=False, escalate=True, impl=None):
    """Exact list tracing (listtrace.py:687-817): the main pass, then a
    COMPACTED per-ray escalation pass over the live rays it could not
    certify, under the span ``query``.  Returns (t [B], packed [B],
    resolved [B], overflow) where overflow is the honest flag: some live
    ray is still uncertified."""
    with span("query", rays=ray_o.shape[0]):
        return _query(scene, ray_o, ray_d, t_lim, maxc, any_hit, sort, mask,
                      share, escalate, impl)


def _query(scene, ray_o, ray_d, t_lim, maxc, any_hit, sort, mask, share,
           escalate, impl):
    B = ray_o.shape[0]
    dev = ray_o.device
    div = ESC_CAP_DIV
    if scene.list_maxc:
        div = max(1, div // max(1, scene.list_maxc // DEFAULT_MAXC))
    cap = min(B, max(256, -(-B // (div * 256)) * 256))
    live = torch.ones((B,), dtype=torch.bool, device=dev) if mask is None \
        else mask
    ah = torch.full((B,), any_hit, dtype=torch.bool, device=dev) \
        if isinstance(any_hit, bool) else any_hit
    will_escalate = escalate and (share or maxc < 128)
    t, packed, resolved = _run_once(
        scene, ray_o, ray_d, t_lim, maxc, any_hit, sort=sort, mask=mask,
        share=share, impl=impl,
    )
    if will_escalate:
        redo = live & ~_certain(ah, packed, resolved)
        # a launch where every ray certified skips the pass (the merge
        # below would be the identity)
        if host_read("redo", redo.any()):
            with span("query.escalate"):
                maxc2 = min(128, 2 * maxc)
                # stable partition, redo rays first (int key: CUDA sorts
                # no bool)
                perm_r = torch.argsort((~redo).to(torch.int32), stable=True)
                idx = perm_r[:cap]
                t2c, p2c, r2c = _run_once(
                    scene, ray_o[idx], ray_d[idx], t_lim[idx], maxc2,
                    ah[idx], sort=True, mask=redo[idx], share=False,
                    force_dense=True, impl=impl,
                )
                # merge back: original row -> its compact slot; redo rays
                # past ``cap`` stay uncertified and keep the overflow flag
                # honest
                pos = torch.cumsum(redo.to(torch.int32), dim=0) - 1
                slot = torch.clamp(pos, 0, cap - 1)
                covered = redo & (pos < cap)
                t2 = torch.where(covered, t2c[slot], t)
                p2 = torch.where(covered, p2c[slot], packed)
                r2 = torch.where(covered, r2c[slot], resolved)
                # a certified per-ray answer replaces the union answer;
                # uncertified ones keep whichever hit is nearer
                use2 = redo & (r2 | (t2 < t))
                t = torch.where(use2, t2, t)
                packed = torch.where(use2, p2, packed)
                resolved = resolved | (redo & r2)
    overflow = (live & ~_certain(ah, packed, resolved)).any()
    return t, packed, resolved, overflow


def _check_scene(scene: ClusterScene):
    if scene.num_clusters > MAX_CLUSTERS:
        raise ValueError(
            f"scene too large for the list tracer ({scene.num_clusters} "
            f"clusters > {MAX_CLUSTERS})")


def _resolve_share(share, maxc) -> bool:
    if share is not None:
        return bool(share)
    if maxc is not None:
        # a pinned maxc asks for per-ray lists of exactly that depth
        return False
    return LIST_SHARE_DEFAULT


def _default_maxc(share, scene: ClusterScene | None = None) -> int:
    """Candidate-list depth: the scene's regrow override (per-ray depth;
    share-mode unions scale by DEFAULT_MAXC_SHARE/DEFAULT_MAXC) else the
    module defaults; capped at 128 by the packed-winner encoding."""
    if scene is None or not scene.list_maxc:
        return DEFAULT_MAXC_SHARE if share else DEFAULT_MAXC
    base = scene.list_maxc
    mc = base * DEFAULT_MAXC_SHARE // DEFAULT_MAXC if share else base
    return min(128, mc)


@torch.no_grad()
def closest_hit(scene: ClusterScene, ray_o, ray_d, maxc: int | None = None,
                mask=None, share=None, with_resolved: bool = False,
                impl=None):
    """Closest hit for rays [B,3] -> (t [B], prim [B] i32 -1 on miss,
    overflow[, resolved]).  ``maxc=None``: block-shared lists plus the
    per-ray escalation pass; a pinned ``maxc``: per-ray lists of that
    depth and no escalation."""
    _check_scene(scene)
    share = _resolve_share(share, maxc)
    escalate = maxc is None
    maxc = _default_maxc(share, scene) if maxc is None else maxc
    B = ray_o.shape[0]
    t_lim = torch.full((B,), BIG_T, dtype=ray_o.dtype, device=ray_o.device)
    t, packed, resolved, overflow = _run(
        scene, ray_o, ray_d, t_lim, maxc, any_hit=False, mask=mask,
        share=share, escalate=escalate, impl=impl,
    )
    t, prim = packed_to_prim(scene, t, packed)
    if with_resolved:
        return t, prim, overflow, resolved
    return t, prim, overflow


@torch.no_grad()
def any_hit(scene: ClusterScene, ray_o, ray_d, t_max, maxc: int | None = None,
            mask=None, share=None, impl=None):
    """Occlusion: True where a triangle lies at t < t_max - SHADOW_EPS
    (render_kernel.cpp:744-759).  Returns (blocked [B] bool, overflow)."""
    _check_scene(scene)
    share = _resolve_share(share, maxc)
    escalate = maxc is None
    maxc = _default_maxc(share, scene) if maxc is None else maxc
    _t, packed, _res, overflow = _run(
        scene, ray_o, ray_d, t_max - SHADOW_EPS, maxc, any_hit=True,
        mask=mask, share=share, escalate=escalate, impl=impl,
    )
    return packed >= 0, overflow


def intersect_list(scene: ClusterScene, tris, ray_o, ray_d,
                   of: list | None = None, mask=None, share=None,
                   impl=None) -> Hit:
    """Closest hit with a differentiable hit record (listtrace.py:900-912):
    ``closest_hit`` records no graph, ``finalize_hit`` re-intersects the
    winner.  ``of``: optional list the overflow flag is appended to."""
    _t, prim, overflow = closest_hit(scene, ray_o.detach(), ray_d.detach(),
                                     mask=mask, share=share, impl=impl)
    if of is not None:
        of.append(overflow)
    return finalize_hit(ray_o, ray_d, tris, prim)


@torch.no_grad()
def multi_query(scene: ClusterScene, queries, maxc: int | None = None,
                share=None, impl=None):
    """FUSED scene queries: one sort + candidate build + launch for
    several ray sets (listtrace.py:915-974).

    ``queries``: list of (ray_o [B,3], ray_d [B,3], t_lim [B] or None for
    closest-hit, mask [B] or None[, any_hit bool]).  Returns (results,
    overflow) with results[i] = (t [B], packed [B]); packed >= 0 means "a
    triangle lies below t_lim".  Any-hit queries read only packed >= 0.

    Traversal records no autograd graph, like every query here (the JAX
    package's stop_gradient, listtrace.py:906-907, 954-956): gradients
    reach a scene through ``finalize_hit``'s re-intersection of the
    winner and the shading."""
    _check_scene(scene)
    share = _resolve_share(share, maxc)
    escalate = maxc is None
    maxc = _default_maxc(share, scene) if maxc is None else maxc
    os_, ds_, tls, masks, ahs = [], [], [], [], []
    for q in queries:
        o, d, tl, m = q[:4]
        ah = bool(q[4]) if len(q) > 4 else False
        B = o.shape[0]
        os_.append(o)
        ds_.append(d)
        tls.append(torch.full((B,), BIG_T, dtype=o.dtype, device=o.device)
                   if tl is None else tl)
        masks.append(torch.ones((B,), dtype=torch.bool, device=o.device)
                     if m is None else m)
        ahs.append(torch.full((B,), ah, dtype=torch.bool, device=o.device))
    t, packed, _resolved, overflow = _run(
        scene, torch.cat(os_), torch.cat(ds_), torch.cat(tls), maxc,
        any_hit=torch.cat(ahs), mask=torch.cat(masks), share=share,
        escalate=escalate, impl=impl,
    )
    results = []
    lo = 0
    for q in queries:
        B = q[0].shape[0]
        results.append((t[lo:lo + B], packed[lo:lo + B]))
        lo += B
    return results, overflow


def packed_to_prim(scene: ClusterScene, t, packed):
    """(t, packed) -> (t, prim) closest-hit record (-1 / BIG_T on miss)."""
    hit = packed >= 0
    win = torch.clamp_min(packed, 0).long()
    prim = scene.cl_tri_idx[win // T_CLUSTER, win % T_CLUSTER]
    return torch.where(hit, t, BIG_T), torch.where(hit, prim, -1)

