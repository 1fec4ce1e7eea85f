"""The port's cluster tables, scene tables and exact candidate builds
against the JAX package: identical arrays (same numpy code, same explicit
cluster order on both sides; the candidate build is integer key work on
bit-identical float slab tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.ops import cluster as JC
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu.utils.procedural import dragon_standin
from sycl_ray_tracing_tpu_torch.models.scene import (
    make_materials,
    make_scene,
    scene_from_numpy,
)
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene


def jax_scene_arrays(scene) -> dict:
    """A JAX Scene's leaves as numpy arrays, in scene_from_numpy's names."""
    a = dict(
        triangles=scene.triangles,
        material_indices=scene.material_indices,
        emissive_indices=scene.emissive_indices,
        emission=scene.materials.emission,
        diffuse=scene.materials.diffuse,
        metalness=scene.materials.metalness,
        roughness=scene.materials.roughness,
        tri_areas=scene.tri_areas,
    )
    if scene.slot_packed is not None:
        a["slot_packed"] = scene.slot_packed
    if scene.env_map is not None:
        for f in scene.env_map._fields:
            a[f"env_{f}"] = getattr(scene.env_map, f)
    if scene.num_spheres:
        for f in ("sphere_centers", "sphere_radii", "sphere_material"):
            a[f] = getattr(scene, f)
    if scene.clusters is not None:
        for f in PC.CLUSTER_FIELDS + PC.CLUSTER_STATIC:
            a[f] = getattr(scene.clusters, f)
    if scene.bvh is not None:
        for f in ("nodes_box", "nodes_meta", "leaf_tris", "tri_order",
                  "leaf_size"):
            a[f"bvh_{f}"] = getattr(scene.bvh, f)
    return {k: np.asarray(v) for k, v in a.items()}


def _random_rays(n, rng, lo=-3.0, hi=3.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def tris():
    return dragon_standin(3_000)


@pytest.mark.parametrize("order", ["sah", "morton", "perm"])
def test_cluster_tables_identical(tris, order):
    if order == "sah":
        perm = PC.sah_order(tris)
        assert np.array_equal(np.sort(perm), np.arange(tris.shape[0]))
        jcs = JC.build_clusters(tris, order=perm)
    elif order == "morton":
        perm = order
        jcs = JC.build_clusters(tris, order="morton")
    else:
        perm = np.random.default_rng(1).permutation(tris.shape[0])
        jcs = JC.build_clusters(tris, order=perm)
    arrays = PC.build_cluster_arrays(tris, perm)
    for f in PC.CLUSTER_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jcs, f)),
                                      err_msg=f)


def test_scene_tables_and_scene_from_numpy():
    """make_scene + build_acceleration give the JAX package's areas,
    emitters and slot_packed table for the same cluster order, and
    scene_from_numpy carries a JAX scene across unchanged."""
    js = jax_dragon(n_tris=2_000, with_sky=True, sky_res=(16, 32))
    ja = jax_scene_arrays(js)
    ps = dragon_scene(n_tris=2_000, with_sky=True, sky_res=(16, 32),
                      build_accel=False, device="cpu")
    # the JAX scene's own cluster order (it may be its Morton fallback)
    order = np.asarray(js.clusters.cl_tri_idx).reshape(-1)
    order = order[order >= 0]
    ps = ps.build_acceleration(order=order)
    np.testing.assert_array_equal(ps.triangles.numpy(), ja["triangles"])
    np.testing.assert_array_equal(ps.emissive_indices.numpy(),
                                  ja["emissive_indices"])
    np.testing.assert_allclose(ps.tri_areas.numpy(), ja["tri_areas"],
                               rtol=1e-6)
    np.testing.assert_array_equal(ps.slot_packed.numpy(), ja["slot_packed"])
    for f in PC.CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(ps.clusters, f).numpy(), ja[f])
    for f in js.env_map._fields:
        np.testing.assert_array_equal(getattr(ps.env_map, f).numpy(),
                                      ja[f"env_{f}"])
    carried = scene_from_numpy(ja, "cpu")
    np.testing.assert_array_equal(carried.slot_packed.numpy(),
                                  ja["slot_packed"])
    np.testing.assert_array_equal(carried.clusters.cl_tris.numpy(),
                                  ja["cl_tris"])
    assert carried.num_lights == js.num_lights


def test_make_scene_emitters():
    mats = make_materials(emission=[(1, 0, 1), (0, 0, 0), (2, 2, 2)],
                          diffuse=[(0, 0, 0)] * 3, metalness=[0, 0, 0],
                          roughness=[1, 1, 1], device="cpu")
    tris = np.zeros((4, 3, 3), np.float32)
    scene = make_scene(tris, [0, 1, 2, 2], mats, device="cpu")
    # row 0 (debug magenta) never counts as a light
    assert scene.emissive_indices.tolist() == [2, 3]


def _both_clusters(tris):
    perm = PC.sah_order(tris)
    return (JC.build_clusters(tris, order=perm),
            PC.build_clusters(tris, order=perm, device="cpu"))


def _slab_inputs(rng, n, t_max):
    o, d = _random_rays(n, rng)
    tl = np.full(n, t_max, np.float32)
    return o, d, tl


@pytest.mark.parametrize("maxc", [4, 16, 128])
def test_candidate_clusters_identical(tris, maxc):
    jcs, pcs = _both_clusters(tris)
    o, d, tl = _slab_inputs(np.random.default_rng(maxc), 192, 3e38)
    tl[::5] = 1.5            # some short limits
    tl[::7] = -3e38          # dead rays
    jout = JC.candidate_clusters(jcs, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tl), maxc, exact=True)
    pout = PC.candidate_clusters(pcs, torch.tensor(o), torch.tensor(d),
                                 torch.tensor(tl), maxc)
    for name, a, b in zip(("cand", "ctn", "overflow"), jout, pout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    if maxc == 4:
        assert bool(pout[2])     # the small depth really overflows


@pytest.mark.parametrize("maxc", [8, 32, 128])
def test_candidate_clusters_grouped_identical(tris, maxc):
    jcs, pcs = _both_clusters(tris)
    o, d, tl = _slab_inputs(np.random.default_rng(100 + maxc), 256, 3e38)
    tl[::3] = 2.0
    tl[::11] = -3e38
    jout = JC.candidate_clusters_grouped(
        jcs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl), maxc, 32,
        exact=True, ray_cert=True)
    pout = PC.candidate_clusters_grouped(
        pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl), maxc, 32)
    for name, a, b in zip(("cand", "ctn", "overflow", "covered"), jout, pout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    if maxc == 8:
        # full unions: some rays certified by membership, some not
        cov = pout[3].numpy()
        assert bool(pout[2]) and cov.any() and not cov.all()


def test_grouped_build_chunking_is_exact(tris, monkeypatch):
    """Row chunks bound the [rows, K2] transients without changing any
    result."""
    _, pcs = _both_clusters(tris)
    o, d, tl = _slab_inputs(np.random.default_rng(5), 512, 3e38)
    args = (pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl), 16, 32)
    whole = PC.candidate_clusters_grouped(*args)
    monkeypatch.setattr(PC, "_CHUNK_ELEMS", 64 * pcs.num_clusters)
    chunked = PC.candidate_clusters_grouped(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_extraction_key_order():
    """Hand-made rows: nearest-first order, entry-t rounded down to the
    key grid, empty slots (-1, BIG_T), and the overflow flag."""
    hit = torch.tensor([[True, False, True, True], [False] * 4])
    tnear = torch.tensor([[3.0, 0.0, 1.0, 2.0], [0.0] * 4])
    cand, ctn, of = PC.extract_candidates(hit, tnear, 2)
    assert cand.tolist() == [[2, 3], [-1, -1]]
    assert bool(of)                          # row 0 has 3 hits > maxc 2
    assert (ctn[0] <= torch.tensor([1.0, 2.0])).all()
    assert torch.equal(ctn[1], torch.full((2,), BIG_T))
    jc, jt, jo = JC._extract_candidates_topk(jnp.asarray(hit.numpy()),
                                             jnp.asarray(tnear.numpy()), 2,
                                             4, exact=True)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ctn.numpy(), np.asarray(jt))


def test_negative_zero_entry_t_keys_like_jax():
    """torch keeps -0.0 through a clamp where XLA gives +0.0: an entry-t of
    -0.0 (a ray starting on a box's far face, pointing in) must key like
    0, or it sorts ahead of every +0.0 column and its ctn reads -0.0."""
    hit = torch.ones((1, 3), dtype=torch.bool)
    tnear = torch.tensor([[0.0, -0.0, 1.0]])
    for extract, jax_extract in (
            (PC.extract_candidates,
             lambda h, t: JC._extract_candidates_topk(h, t, 3, 3, exact=True)),
            (PC.extract_candidates_min,
             lambda h, t: JC._extract_candidates(h, t, 3, 3))):
        cand, ctn, _of = extract(hit, tnear, 3)
        jc, jt, _jo = jax_extract(jnp.asarray(hit.numpy()),
                                  jnp.asarray(tnear.numpy()))
        assert cand.tolist() == [[0, 1, 2]]
        np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
        assert not torch.signbit(ctn).any()
        np.testing.assert_array_equal(ctn.numpy().view(np.int32),
                                      np.asarray(jt).view(np.int32))


@pytest.mark.parametrize("maxc", [4, 16, 128])
def test_threshold_min_extraction_identical(maxc):
    """One sort of the packed keys gives _extract_candidates' maxc
    threshold-min rounds: cand bit for bit, ctn on every slot, overflow;
    with zero, -0.0, negative and above-1e30 entry-t among the hits."""
    rng = np.random.default_rng(maxc)
    hit = rng.random((64, 100)) < 0.3
    hit[0] = False                                   # an empty row
    tn = rng.uniform(-1.0, 5.0, (64, 100)).astype(np.float32)
    tn[:, ::9] = 0.0
    tn[:, 1::9] = -0.0
    tn[:, 2::13] = 2e30
    jc, jt, jo = JC._extract_candidates(jnp.asarray(hit), jnp.asarray(tn),
                                        maxc, 100)
    pc, pt, po = PC.extract_candidates_min(torch.tensor(hit),
                                           torch.tensor(tn), maxc)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pt.numpy().view(np.int32),
                                  np.asarray(jt).view(np.int32))
    assert bool(po) == bool(jo) == (maxc < hit.sum(axis=1).max())


@pytest.fixture(scope="module")
def hier_mesh():
    """A mesh of 4 superclusters (256 clusters), and rays half in a tight
    bundle (blocks within few superclusters), half random (blocks that hit
    more than 2)."""
    tris = dragon_standin(30_000)
    jcs, pcs = _both_clusters(tris)
    rng = np.random.default_rng(13)
    B = 256
    o, d = _random_rays(B, rng)
    h = B // 2
    o[:h] = np.array([0.0, 0.2, 3.0], np.float32)
    dd = np.stack([np.linspace(-0.02, 0.02, h), np.linspace(-0.01, 0.01, h),
                   np.full(h, -1.0)], axis=1).astype(np.float32)
    d[:h] = dd / np.linalg.norm(dd, axis=-1, keepdims=True)
    tl = np.full(B, 3e38, np.float32)
    tl[h::5] = 1.5
    tl[h::7] = -3e38
    return jcs, pcs, (o, d, tl)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("maxs", [2, 4])
def test_candidate_clusters_hier_identical(hier_mesh, grouped, maxs):
    """The supercluster build against the JAX package's, per-ray and
    grouped (with the membership certificate), with SC overflow (maxs 2 of
    4 superclusters: poisoned rows) and without (maxs 4): cand, ctn,
    overflow and covered identical."""
    jcs, pcs, (o, d, tl) = hier_mesh
    group, maxc = (32, 48) if grouped else (8, 8)
    jout = JC.candidate_clusters_hier(
        jcs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl), maxc,
        maxs=maxs, group=group, grouped=grouped, exact=True,
        ray_cert=grouped)
    pout = PC.candidate_clusters_hier(
        pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl), maxc, maxs,
        group, grouped=grouped, ray_cert=grouped)
    assert len(pout) == len(jout)
    for name, a, b in zip(("cand", "ctn", "overflow", "covered"), jout, pout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    poisoned = pout[1][:, -1] < 0
    if maxs == 2:
        assert poisoned.any() and not poisoned.all() and bool(pout[2])
    else:
        assert not poisoned.any()
    if grouped:
        cov = pout[3].numpy()
        assert cov.any() and not cov.all()
        assert not cov[np.repeat(poisoned.numpy(), group)].any()


def test_hier_matches_dense_without_sc_overflow(hier_mesh):
    """Without SC overflow the supercluster build keeps the dense build's
    candidates: on rows that fit, the same set (the order may differ only
    among equal quantized entry-t: local and global ids break ties
    differently), and ctn slot by slot within the id-bit quantization."""
    _jcs, pcs, (o, d, tl) = hier_mesh
    args = (pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl), 32)
    hc, ht, hof = PC.candidate_clusters_hier(*args, 4, 8)
    dc, dt, dof = PC.candidate_clusters(*args)
    assert bool(hof) == bool(dof)
    assert torch.equal((hc >= 0).sum(dim=1), (dc >= 0).sum(dim=1))
    fits = dc[:, -1] < 0
    assert fits.any()
    assert torch.equal(hc[fits].sort(dim=1).values, dc[fits].sort(dim=1).values)
    live = dc >= 0
    assert torch.allclose(ht[live], dt[live], rtol=2.0 ** -11, atol=0.0)
    # the bundle's rows have no ties: identical lists
    assert torch.equal(hc[:128], dc[:128])


def test_hier_ray_cert_needs_grouped(hier_mesh):
    _jcs, pcs, (o, d, tl) = hier_mesh
    with pytest.raises(ValueError, match="grouped"):
        PC.candidate_clusters_hier(pcs, torch.tensor(o), torch.tensor(d),
                                   torch.tensor(tl), 8, 2, 8, ray_cert=True)


@pytest.mark.parametrize("grouped", [False, True])
def test_hier_build_chunking_is_exact(hier_mesh, monkeypatch, grouped):
    """Block-aligned row chunks change no result of the supercluster
    build."""
    _jcs, pcs, (o, d, tl) = hier_mesh
    args = (pcs, torch.tensor(o), torch.tensor(d), torch.tensor(tl), 16, 2,
            32)
    whole = PC.candidate_clusters_hier(*args, grouped=grouped,
                                       ray_cert=grouped)
    monkeypatch.setattr(PC, "_CHUNK_ELEMS", 64 * 2 * PC.S_CLUSTER)
    chunked = PC.candidate_clusters_hier(*args, grouped=grouped,
                                         ray_cert=grouped)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
