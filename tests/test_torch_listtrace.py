"""The port's list tracer against the JAX list tracer (Pallas in interpret
mode on CPU) and the brute-force oracle.

Tolerances: packed winners, certificates and overflow flags identical;
t within 1e-5, the golden-ray tolerance (tests/test_golden_rays.py:20) —
XLA may contract the Möller–Trumbore products into FMAs where torch does
not.  On CPU tensors every kernel wrapper runs its plain torch version.

Both list kernels run the TPU kernel's tail guard (the block kernel per
block, the per-ray kernel per ray), which the JAX kernels in interpret
mode skip: there an any-hit ray that is already blocked may keep a
farther hit than the nearest, as on the TPU.  So any-hit rays are held to
what their callers read, "blocked" (packed >= 0) and certain
(``_certain``); closest-hit rays stay exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.ops import cluster as JC
from sycl_ray_tracing_tpu.ops.pallas import listtrace as JL
from sycl_ray_tracing_tpu.utils.procedural import dragon_standin
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T, intersect_triangles
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL
from sycl_ray_tracing_tpu_torch.ops.kernels import probes as PK
from sycl_ray_tracing_tpu_torch.ops.kernels import rows as RW
from sycl_ray_tracing_tpu_torch.utils import procedural
from torch_card import (  # noqa: F401
    BOUNCES,
    H,
    KERNELS,
    TILE,
    W,
    aimed_rays,
    assert_certified_hits_are_brute_force,
    card,
    held_launches,
    main_tile,
    recorded_runs,
)

T_TOL = 1e-5


def _rays(rng, n, lo=-3.0, hi=3.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def mesh():
    tris = dragon_standin(4_000)
    perm = PC.sah_order(tris)
    return tris, JC.build_clusters(tris, order=perm), PC.build_clusters(
        tris, order=perm, device="cpu")


def _compare_run(jout, pout, ah=None):
    """_run's outputs equal JAX's.  ``ah``: the any-hit rays, held to
    blocked and certain only (the guard may stop them early)."""
    jt, jp, jr, jo = (np.asarray(x) for x in jout)
    pt, pp, pr, po = (x.numpy() for x in pout)
    assert bool(po) == bool(jo)
    hit = jp >= 0
    exact = np.ones_like(hit) if ah is None else ~ah
    if ah is not None:
        np.testing.assert_array_equal((pp >= 0)[ah], hit[ah])
        np.testing.assert_array_equal((pr | (pp >= 0))[ah], (jr | hit)[ah])
    np.testing.assert_array_equal(pp[exact], jp[exact])
    np.testing.assert_array_equal(pr[exact], jr[exact])
    np.testing.assert_allclose(pt[hit & exact], jt[hit & exact],
                               rtol=T_TOL, atol=T_TOL)
    assert (pt[~hit] == BIG_T).all()
    return hit


@pytest.mark.parametrize("case", ["per_ray_pinned", "per_ray_escalate",
                                  "shared_escalate"])
def test_run_matches_jax(mesh, case):
    """_run with masks, mixed any-hit rays and finite t_lims; the escalation
    cases shrink the list depth (scene.list_maxc on both sides) so the
    compacted per-ray pass sees real work."""
    _tris, jcs, pcs = mesh
    rng = np.random.default_rng(len(case))
    B = 320
    o, d = _rays(rng, B)
    tl = np.where(rng.random(B) < 0.3, 2.0, BIG_T).astype(np.float32)
    mask = rng.random(B) < 0.85
    ah = rng.random(B) < 0.4
    share = case == "shared_escalate"
    escalate = case != "per_ray_pinned"
    if escalate:
        jcs = jcs.with_list_maxc(4)
        pcs = pcs.with_list_maxc(4)
    maxc = 8
    if escalate:
        maxc = JL._default_maxc(share, jcs)
        assert maxc == PL._default_maxc(share, pcs)
    jout = JL._run(jcs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl),
                   maxc, jnp.asarray(ah), mask=jnp.asarray(mask),
                   share=share, escalate=escalate)
    pout = PL._run(pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl),
                   maxc, torch.tensor(ah), mask=torch.tensor(mask),
                   share=share, escalate=escalate)
    hit = _compare_run(jout, pout, ah)
    assert hit.any() and not hit[~mask].any()
    if escalate:
        # the main pass alone leaves uncertified rays: escalation ran
        _t, packed, resolved = PL._run_once(
            pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl), maxc,
            torch.tensor(ah), mask=torch.tensor(mask), share=share)
        redo = torch.tensor(mask) & ~PL._certain(torch.tensor(ah), packed,
                                                 resolved)
        assert redo.any()


@pytest.mark.parametrize("share", [False, True])
def test_multi_query_matches_jax(mesh, share):
    """A fused closest-hit + occlusion launch, as each bounce issues it."""
    _tris, jcs, pcs = mesh
    rng = np.random.default_rng(7)
    B = 256
    o, d = _rays(rng, B)
    o2, d2 = _rays(rng, B)
    tmax = np.full(B, 2.5 - 1e-4, np.float32)
    m2 = rng.random(B) < 0.7
    jres, jof = JL.multi_query(jcs, [
        (jnp.asarray(o), jnp.asarray(d), None, None, False),
        (jnp.asarray(o2), jnp.asarray(d2), jnp.asarray(tmax),
         jnp.asarray(m2), True),
    ], share=share)
    pres, pof = PL.multi_query(pcs, [
        (torch.tensor(o), torch.tensor(d), None, None, False),
        (torch.tensor(o2), torch.tensor(d2), torch.tensor(tmax),
         torch.tensor(m2), True),
    ], share=share)
    assert bool(pof) == bool(jof)
    (jt, jp), (pt, pp) = jres[0], pres[0]             # closest hit: exact
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    hit = np.asarray(jp) >= 0
    np.testing.assert_allclose(pt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=T_TOL, atol=T_TOL)
    (jt, jp), (pt, pp) = jres[1], pres[1]             # occlusion
    blocked = np.asarray(jp) >= 0
    assert blocked.any() and not blocked.all()
    # the guard may stop a blocked ray before its nearest hit: blocked only
    np.testing.assert_array_equal(pp.numpy() >= 0, blocked)
    jt, jprim = JL.packed_to_prim(jcs, *jres[0])
    pt, pprim = PL.packed_to_prim(pcs, *pres[0])
    np.testing.assert_array_equal(pprim.numpy(), np.asarray(jprim))


@pytest.mark.parametrize("share", [False, True])
def test_closest_hit_and_any_hit_match_oracle(mesh, share):
    tris, _jcs, pcs = mesh
    rng = np.random.default_rng(11 + share)
    o, d = _rays(rng, 512)
    po, pd = torch.tensor(o), torch.tensor(d)
    oracle = intersect_triangles(po, pd, torch.tensor(tris))
    t, prim, of, res = PL.closest_hit(pcs, po, pd, share=share,
                                      with_resolved=True)
    assert bool(of) == bool((~res).any())
    assert res.float().mean() > 0.99
    m = oracle.hit
    assert torch.equal((prim >= 0)[res], m[res])
    mr = m & res
    assert torch.equal(prim[mr], oracle.prim[mr])
    np.testing.assert_allclose(t[mr].numpy(), oracle.t[mr].numpy(),
                               rtol=T_TOL, atol=T_TOL)
    tmax = torch.full((512,), 2.0)
    blocked, _of = PL.any_hit(pcs, po, pd, tmax, share=share)
    assert torch.equal(blocked, m & (oracle.t + 1e-4 < 2.0))


def test_masked_rays_are_clean_misses(mesh):
    _tris, _jcs, pcs = mesh
    rng = np.random.default_rng(21)
    o, d = _rays(rng, 300)
    mask = torch.tensor(rng.random(300) < 0.3)
    t_m, p_m, _ = PL.closest_hit(pcs, torch.tensor(o), torch.tensor(d),
                                 mask=mask)
    t_u, p_u, _ = PL.closest_hit(pcs, torch.tensor(o), torch.tensor(d))
    assert torch.equal(p_m[mask], p_u[mask])
    assert torch.equal(t_m[mask], t_u[mask])
    assert (p_m[~mask] == -1).all() and (t_m[~mask] == BIG_T).all()


def test_wrappers_dispatch_on_device(mesh):
    """CPU tensors run the plain versions (and count no launch); asking for
    the CUDA kernel with CPU tensors raises; bad arguments raise."""
    _tris, _jcs, pcs = mesh
    tiles = PL._tiles_with_dummy(pcs)
    k2 = pcs.num_clusters
    rng = np.random.default_rng(3)
    cand = torch.tensor(rng.integers(0, k2 + 1, (4, 16)), dtype=torch.int32)
    o, d = _rays(rng, 128)
    rays = torch.cat([torch.tensor(o), torch.tensor(d),
                      torch.full((128, 1), BIG_T), torch.zeros((128, 1))], 1)
    ctn = torch.zeros((4, 16))          # entry-t 0: the guard never fires
    PL.reset_launch_counts()
    at, ar, stop = PL.block_tiles(cand, ctn, rays, tiles)
    at2, ar2, stop2 = PL.block_tiles_plain(cand, ctn, rays, tiles)
    assert torch.equal(at, at2) and torch.equal(ar, ar2)
    assert torch.equal(stop, stop2) and (stop == 16).all()
    lcand = cand.repeat_interleave(32, dim=0)
    lctn = ctn.repeat_interleave(32, dim=0)
    at3, ar3, stop3 = PL.list_tiles(lcand, lctn, rays, tiles)
    # per-ray lists equal to the block's list give the block answer
    assert torch.equal(at3, at) and torch.equal(ar3, ar)
    assert stop3.shape == (128,) and (stop3 == 16).all()
    assert all(torch.equal(a, b) for a, b in zip(
        PL.list_tiles_plain(lcand, lctn, rays, tiles), (at3, ar3, stop3)))
    assert PL.LAUNCHES == {"block_tiles": 0, "list_tiles": 0}
    with pytest.raises(ValueError):
        PL.block_tiles(cand, ctn, rays, tiles, impl="cuda")
    with pytest.raises(ValueError):
        PL.block_tiles_cuda(cand, ctn, rays, tiles)
    with pytest.raises(ValueError):
        PL.list_tiles(lcand, lctn, rays, tiles, impl="triton")
    with pytest.raises(ValueError):
        PL.list_tiles(lcand, lctn, rays, tiles, impl="cuda")
    with pytest.raises(ValueError):
        PL.list_tiles_cuda(lcand, lctn, rays, tiles)
    with pytest.raises(ValueError):
        PL.list_tiles(lcand, lctn[:, :8], rays, tiles)
    with pytest.raises(ValueError):
        PL.block_tiles(cand, ctn, rays[:64], tiles)
    with pytest.raises(ValueError):
        PL.block_tiles(cand, ctn[:, :8], rays, tiles)
    with pytest.raises(TypeError):
        PL.list_tiles(lcand.long(), lctn, rays, tiles)


def test_plain_kernel_round_rule():
    """The plain kernel keeps the per-lane min over rounds with a strict
    '<' (the earliest round wins a tie) and skips no real round."""
    tri = np.array([[0, 0, -2], [1, 0, -2], [0, 1, -2]], np.float32)
    tiles = torch.zeros((3, 9, 128))
    tiles[0, :, 5] = torch.tensor(tri.reshape(-1))  # planar ax ay az bx ..
    tiles[1, :, 5] = torch.tensor(tri.reshape(-1))  # the same triangle
    rays = torch.tensor([[0.2, 0.2, 0.0, 0.0, 0.0, -1.0, BIG_T, 0.0]])
    cand = torch.tensor([[2, 1, 0]], dtype=torch.int32)  # dummy first
    at, ar, stop = PL.list_tiles(cand, torch.zeros((1, 3)), rays, tiles)
    assert int(stop[0]) == 3                 # maxc <= GROUP: no check
    assert float(at[0, 5]) == pytest.approx(2.0)
    assert int(ar[0, 5]) == 1                            # earliest round
    assert (ar[0, :5] == -1).all() and (at[0, :5] == BIG_T).all()


def _cluster_scene(pcs, k2):
    """``pcs``'s superclusters and child boxes over a table of ``k2``
    all-zero clusters (tiles that never hit)."""
    return PC.ClusterScene(
        sc_box=pcs.sc_box, cl_box_rows=pcs.cl_box_rows,
        cl_box=torch.zeros((k2, 8)), cl_tris=torch.zeros((k2, 9 * 128)),
        cl_tri_idx=torch.zeros((k2, 128), dtype=torch.int32))


class _Spy:
    """Wraps PL.candidate_clusters_hier, recording each call's ``grouped``
    and how many of its rows came poisoned (SC overflow)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self._orig = PL.candidate_clusters_hier
        monkeypatch.setattr(PL, "candidate_clusters_hier", self)

    def __call__(self, *args, **kw):
        out = self._orig(*args, **kw)
        self.calls.append((kw.get("grouped", False),
                           int((out[1][:, -1] < 0).sum())))
        return out


def test_hierarchical_scenes_take_the_supercluster_build(mesh, monkeypatch):
    """Scenes above 2*maxs*64 clusters take the supercluster build (block
    lists in share mode, per-ray lists at a pinned maxc); only scenes
    above MAX_CLUSTERS raise."""
    _tris, _jcs, pcs = mesh
    big = _cluster_scene(pcs, 2 * 42 * 64 + 64)
    o = torch.zeros((64, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(64, 1)
    spy = _Spy(monkeypatch)
    t, prim, of = PL.closest_hit(big, o, d)
    assert [g for g, _ in spy.calls] == [True]
    t, prim, of = PL.closest_hit(big, o, d, maxc=8)
    assert [g for g, _ in spy.calls] == [True, False]
    assert (prim == -1).all() and (t == BIG_T).all() and not bool(of)
    with pytest.raises(ValueError, match="too large"):
        PL.closest_hit(_cluster_scene(pcs, PL.MAX_CLUSTERS + 64), o, d)


@pytest.fixture(scope="module")
def big_mesh():
    """A 40k-triangle stand-in: 320 clusters in 5 superclusters, above
    2*maxs*64 = 256 once HIER_MAXS is 1 and maxc is 8 (maxs 2)."""
    tris = dragon_standin(40_000)
    perm = PC.sah_order(tris)
    return JC.build_clusters(tris, order=perm), PC.build_clusters(
        tris, order=perm, device="cpu")


@pytest.mark.parametrize("share", [False, True])
def test_big_branch_matches_jax(big_mesh, monkeypatch, share):
    """_run_once, _run (with its dense escalation) and multi_query through
    the supercluster build, on both packages, with SC-overflow rows among
    the lists the kernels walk: closest-hit rays identical (t within
    1e-5), any-hit rays on blocked and certain."""
    jcs, pcs = big_mesh
    monkeypatch.setattr(JL, "HIER_MAXS", 1)
    monkeypatch.setattr(PL, "HIER_MAXS", 1)
    spy = _Spy(monkeypatch)
    rng = np.random.default_rng(1)
    B = 256
    o, d = _rays(rng, B, -2.0, 2.0)
    tl = np.where(rng.random(B) < 0.3, 2.0, BIG_T).astype(np.float32)
    mask = rng.random(B) < 0.85
    ah = rng.random(B) < 0.4
    jargs = (jcs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl), 8,
             jnp.asarray(ah))
    pargs = (pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl), 8,
             torch.tensor(ah))
    jout = JL._run_once(*jargs, mask=jnp.asarray(mask), share=share,
                        exact=True)
    pout = PL._run_once(*pargs, mask=torch.tensor(mask), share=share)
    assert spy.calls and all(g == share for g, _ in spy.calls)
    assert sum(n for _, n in spy.calls) > 0      # poisoned rows were walked
    _compare_run((*jout[:3], False), (*pout, torch.tensor(False)), ah)
    jout = JL._run(*jargs, mask=jnp.asarray(mask), share=share)
    pout = PL._run(*pargs, mask=torch.tensor(mask), share=share)
    hit = _compare_run(jout, pout, ah)
    assert hit.any() and not hit[~mask].any()
    # a pinned maxc: one pass, per-ray or block lists as asked
    o2, d2 = _rays(rng, B, -2.0, 2.0)
    tmax = np.full(B, 2.5 - 1e-4, np.float32)
    jres, jof = JL.multi_query(jcs, [
        (jnp.asarray(o), jnp.asarray(d), None, None, False),
        (jnp.asarray(o2), jnp.asarray(d2), jnp.asarray(tmax), None, True),
    ], maxc=8, share=share)
    pres, pof = PL.multi_query(pcs, [
        (torch.tensor(o), torch.tensor(d), None, None, False),
        (torch.tensor(o2), torch.tensor(d2), torch.tensor(tmax), None, True),
    ], maxc=8, share=share)
    assert bool(pof) == bool(jof)
    (jt, jp), (pt, pp) = jres[0], pres[0]
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    hit = np.asarray(jp) >= 0
    np.testing.assert_allclose(pt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=T_TOL, atol=T_TOL)
    np.testing.assert_array_equal(pres[1][1].numpy() >= 0,
                                  np.asarray(jres[1][1]) >= 0)


def test_poisoned_last_slot_is_not_walked(big_mesh):
    """An SC-overflow row's poisoned last slot (cluster 0, entry-t -BIG_T)
    lies past empty slots (entry-t BIG_T), so where its real count ends at
    or before the last chunk start, the tail guard stops the row before
    that slot: its walk equals the walk without the slot."""
    _jcs, pcs = big_mesh
    rng = np.random.default_rng(2)
    B, maxc = 512, 32
    o, d = _rays(rng, B, -2.0, 2.0)
    o, d = torch.tensor(o), torch.tensor(d)
    cand, ctn, _of = PC.candidate_clusters_hier(
        pcs, o, d, torch.full((B,), BIG_T), maxc, 1, 8, exact=True)
    k2 = pcs.num_clusters
    cand = torch.where(cand >= 0, cand, k2).to(torch.int32)
    real = torch.where(cand[:, :-1] != k2, torch.arange(1, maxc), 0).amax(1)
    last_c0 = PL.GROUP + (maxc - 1 - PL.GROUP) // PL.CHUNK * PL.CHUNK
    rows = (ctn[:, -1] < 0) & (cand[:, -2] == k2) & (real <= last_c0)
    assert rows.sum() >= 8
    rays = torch.cat([o, d, torch.full((B, 1), BIG_T), torch.zeros((B, 1))],
                     1)[rows].contiguous()
    tiles = PL._tiles_with_dummy(pcs)
    c, t = cand[rows].contiguous(), ctn[rows].contiguous()
    at, ar, stop = PL.list_tiles(c, t, rays, tiles)
    assert (stop < maxc - 1).all()
    c_cut = c.clone()
    c_cut[:, -1] = k2
    at2, ar2, _stop = PL.list_tiles(c_cut, t, rays, tiles)
    assert torch.equal(at, at2) and torch.equal(ar, ar2)


# ---- on a card ----

# each hand-written kernel's *_info call, at the shapes the callers build
INFOS = {
    "block_tiles": PL.block_tiles_info,
    **{f"list_tiles rays_per_block={k}": (lambda k=k: PL.list_tiles_info(k))
       for k in PL.LIST_RAYS_PER_BLOCK},
    **{f"list_tiles_min maxc={m}":
       (lambda m=m: PK.list_tiles_min_info(m, PL.MAX_CLUSTERS + 1))
       for m in (32, 48)},
    **{f"round_probe {v} sub-blocks={sb}":
       (lambda v=v, sb=sb: PK.round_probe_info(v, sb))
       for v in PK.ROUND_VARIANTS for sb in (1, 32)},
    "hier_build maxs=42": lambda: PC.hier_build_info(42),
    **{f"row_sum {r}x{c} {'int64' if i64 else 'int32'}":
       (lambda r=r, c=c, i64=i64: RW.row_sum_info(r, c, i64))
       for r, c in ((4, 8), (2, 12), (2048, 8)) for i64 in (False, True)},
}


@pytest.mark.card
@pytest.mark.parametrize("kernel", list(INFOS))
def test_kernel_builds_without_spilling(card, kernel):
    """Each kernel builds from the checkout's sources and spills nothing
    to local memory; the union walk's block is LIST_MIN_RAYS warps and a
    producer."""
    info = INFOS[kernel]()
    assert info["local_bytes"] == 0, info
    assert info["registers"] > 0 and info["blocks_per_sm"] > 0, info
    if kernel.startswith("list_tiles_min"):
        assert info["threads"] == 32 * (PK.LIST_MIN_RAYS + 1)


@pytest.fixture(scope="module")
def frame_run(card):
    """The 200k dragon's 512x512 frame at 8 bounces (shared estimator) on
    the card, every list-kernel launch held, the first passes recorded."""
    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.ops import rng
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig

    scene, cam = main_tile(card)[:2]
    cfg = RenderConfig(W, H, samples=1, bounces=BOUNCES, intersect="list",
                       estimator="shared", tile_rays=TILE)
    with torch.no_grad(), held_launches() as held, recorded_runs() as runs:
        pt.render(scene, cam, cfg, rng.prng_key(0))
    return dict(scene=scene, held=held, runs=runs)


@pytest.mark.card
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernels_equal_plain_on_the_main_path(frame_run, kernel):
    """Every launch of the frame (main passes, escalations) is its plain
    twin's bit for bit, block launches the guard cut short among them."""
    launches = frame_run["held"][kernel]
    assert launches and all(x["same"] for x in launches), launches
    if kernel == "block_tiles":
        assert any(x["stopped"] for x in launches), launches


@pytest.mark.card
@pytest.mark.parametrize("which", [0, 1], ids=["primary", "bounce1"])
def test_run_equals_plain_on_the_main_path(frame_run, which):
    """_run's (t, packed, resolved, overflow), kernels against twins."""
    *args, kw = frame_run["runs"][which]
    outs = [PL._run(*args, **dict(kw, impl=impl))
            for impl in (None, "plain")]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.card
def test_certified_hits_equal_brute_force_on_the_card(frame_run):
    """On a subset of the first tile's primary rays."""
    o, d = (x[::256] for x in frame_run["runs"][0][1:3])
    assert_certified_hits_are_brute_force(frame_run["scene"], o, d)


@pytest.mark.card
def test_list_path_on_morton_clusters_equals_plain(card):
    """The JAX API's list-path calls on the default (Morton) clusters of
    the 2k stand-in at candidate depth 3 (block lists of 12 slots,
    escalation at 24), where both kernels launch: multi_query (a closest-
    hit and an any-hit query fused), _run and intersect_list equal their
    plain twins bit for bit, multi_query certifies every ray and its
    closest hits are brute force's."""
    tris_np = procedural.dragon_standin(2_000)
    cs = PC.build_clusters(tris_np, device=card).with_list_maxc(3)
    o, d, dist = (x.to(card) for x in aimed_rays(tris_np))
    tris, t_any = torch.tensor(tris_np, device=card), 1.5 * dist
    queries = [(o, d, None, None), (o, d, t_any, None, True)]
    PL.reset_launch_counts()
    of_k, of_p = [], []
    res_k, ovf_k = PL.multi_query(cs, queries)
    hit_k = PL.intersect_list(cs, tris, o, d, of_k)
    assert min(PL.LAUNCHES.values()) >= 1, PL.LAUNCHES
    res_p, ovf_p = PL.multi_query(cs, queries, impl="plain")
    hit_p = PL.intersect_list(cs, tris, o, d, of_p, impl="plain")
    assert not bool(ovf_k) and not bool(ovf_p)
    assert all(torch.equal(a, b) for qk, qp in zip(res_k, res_p)
               for a, b in zip(qk, qp))
    assert bool(of_k[0]) == bool(of_p[0])
    assert all(torch.equal(a, b) for a, b in zip(hit_k, hit_p))
    both = torch.cat([o, o]), torch.cat([d, d])
    t_lim = torch.cat([torch.full_like(t_any, BIG_T), t_any])
    ah = torch.arange(2 * 8192, device=card) >= 8192
    maxc = PL._default_maxc(True, cs)
    runs = [PL._run(cs, *both, t_lim, maxc, ah, share=True, impl=impl)
            for impl in (None, "plain")]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    t_mq, prim_mq = PL.packed_to_prim(cs, *res_k[0])
    ref = intersect_triangles(o, d, tris)
    assert torch.equal(prim_mq.long(),
                       torch.where(ref.hit, ref.prim.long(), -1))
    assert ((t_mq - ref.t).abs()[ref.hit] <= T_TOL).all()
