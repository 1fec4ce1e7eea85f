"""The port's list tracer against the JAX list tracer (Pallas in interpret
mode on CPU) and the brute-force oracle.

Tolerances: packed winners, certificates and overflow flags identical;
t within 1e-5, the golden-ray tolerance (tests/test_golden_rays.py:20) —
XLA may contract the Möller–Trumbore products into FMAs where torch does
not.  On CPU tensors every kernel wrapper runs its plain torch version."""

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
        tris, order=perm)


def _compare_run(jout, pout):
    jt, jp, jr, jo = (np.asarray(x) for x in jout)
    pt, pp, pr, po = (x.numpy() for x in pout)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pr, jr)
    assert bool(po) == bool(jo)
    hit = jp >= 0
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=T_TOL, atol=T_TOL)
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
    hit = _compare_run(jout, pout)
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
    for (jt, jp), (pt, pp) in zip(jres, pres):
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        hit = np.asarray(jp) >= 0
        np.testing.assert_allclose(pt.numpy()[hit], np.asarray(jt)[hit],
                                   rtol=T_TOL, atol=T_TOL)
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
    PL.reset_launch_counts()
    at, ar = PL.block_tiles(cand, rays, tiles)
    at2, ar2 = PL.block_tiles_plain(cand, rays, tiles)
    assert torch.equal(at, at2) and torch.equal(ar, ar2)
    lcand = cand.repeat_interleave(32, dim=0)
    at3, ar3 = PL.list_tiles(lcand, rays, tiles)
    # per-ray lists equal to the block's list give the block answer
    assert torch.equal(at3, at) and torch.equal(ar3, ar)
    assert PL.LAUNCHES == {"block_tiles": 0, "list_tiles": 0}
    with pytest.raises(ValueError):
        PL.block_tiles(cand, rays, tiles, impl="cuda")
    with pytest.raises(ValueError):
        PL.list_tiles(lcand, rays, tiles, impl="triton")
    with pytest.raises(ValueError):
        PL.block_tiles(cand, rays[:64], tiles)
    with pytest.raises(TypeError):
        PL.list_tiles(lcand.long(), rays, tiles)


def test_plain_kernel_round_rule():
    """The plain kernel keeps the per-lane min over rounds with a strict
    '<' (the earliest round wins a tie) and skips no real round."""
    tri = np.array([[0, 0, -2], [1, 0, -2], [0, 1, -2]], np.float32)
    tiles = torch.zeros((3, 9, 128))
    tiles[0, :, 5] = torch.tensor(tri.reshape(-1))  # planar ax ay az bx ..
    tiles[1, :, 5] = torch.tensor(tri.reshape(-1))  # the same triangle
    rays = torch.tensor([[0.2, 0.2, 0.0, 0.0, 0.0, -1.0, BIG_T, 0.0]])
    cand = torch.tensor([[2, 1, 0]], dtype=torch.int32)  # dummy first
    at, ar = PL.list_tiles(cand, rays, tiles)
    assert float(at[0, 5]) == pytest.approx(2.0)
    assert int(ar[0, 5]) == 1                            # earliest round
    assert (ar[0, :5] == -1).all() and (at[0, :5] == BIG_T).all()


def test_hierarchical_scenes_raise(mesh):
    """Scenes above 2*maxs*64 clusters need the supercluster build, which
    is not ported: the list tracer says so instead of guessing."""
    _tris, _jcs, pcs = mesh
    big = PC.ClusterScene(
        sc_box=pcs.sc_box, cl_box_rows=pcs.cl_box_rows,
        cl_box=torch.zeros((2 * 42 * 64 + 64, 8)),
        cl_tris=torch.zeros((2 * 42 * 64 + 64, 9 * 128)),
        cl_tri_idx=torch.zeros((2 * 42 * 64 + 64, 128), dtype=torch.int32),
    )
    o = torch.zeros((64, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(64, 1)
    with pytest.raises(NotImplementedError, match="hierarchical"):
        PL.closest_hit(big, o, d)
