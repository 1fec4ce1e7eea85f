"""The probe kernels' plain versions against the TPU kernels they replace
(Pallas in interpret mode on CPU), the device defaults of the port's
entry points, and the probe workloads at small sizes.

The scratch probe scripts run their benchmarks at import, so their kernel
factories are taken from the source with ``ast`` and built here with
``interpret=True`` at tiny sizes.  Tolerances: exact for the copy
variants, the smoke kernels and the zero outputs; t within 1e-5 for
anything through Möller–Trumbore (XLA:CPU may contract its products into
FMAs, torch does not), winners (rounds) exact."""

import ast
import functools
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sycl_ray_tracing_tpu.ops.pallas import listtrace as JL
from sycl_ray_tracing_tpu_torch.models import camera as pcam
from sycl_ray_tracing_tpu_torch.models import scene as pscene
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL
from sycl_ray_tracing_tpu_torch.ops.kernels import probes as PK
from sycl_ray_tracing_tpu_torch.probes import bounds, chunk, feature_smoke
from sycl_ray_tracing_tpu_torch.probes import micro_round
from sycl_ray_tracing_tpu_torch.probes.common import (
    dummy_lists,
    pack_rays,
    surface_wavefront,
)
from sycl_ray_tracing_tpu_torch.utils import procedural
from torch_card import card, main_tile  # noqa: F401

SCRATCH = Path(__file__).resolve().parents[1] / "scratch"
T_TOL = 1e-5
T = 128


def scratch_defs(script: str, names, **consts) -> dict:
    """The top-level functions ``names`` of a scratch script, executed in
    a namespace holding jax, numpy and Pallas plus ``consts`` (the
    script's module constants, at test sizes)."""
    path = SCRATCH / script
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names)
    ns = dict(jax=jax, jnp=jnp, np=np, pl=pl, pltpu=pltpu, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


# ---- round_probe: micro_copy.py / micro_super.py ----------------------

def _round_call(kernel, rows_per_step, steps, rounds, rb=8):
    return pl.pallas_call(
        kernel,
        grid=(steps,),
        in_specs=[
            pl.BlockSpec((rows_per_step, rounds), lambda b: (b, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((rows_per_step, 1), lambda b: (b, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((steps * rows_per_step, 1),
                                       jnp.float32),
        scratch_shapes=[pltpu.VMEM((9, rb, T), jnp.float32)],
        interpret=True,
    )


@pytest.mark.parametrize("variant", ["dyncopy", "statcopy", "mtonly",
                                     "dynmt"])
def test_round_probe_matches_micro_copy(variant):
    k2, rb, rounds, nb = 16, 8, 4, 4
    ns = scratch_defs("micro_copy.py", ["mk"], K2=k2, T=T, RB=rb, R=rounds)
    w = micro_round.workload("cpu", nb=nb, rounds=rounds, k2=k2)
    cand, tris = w["cand"].numpy(), w["tris"].numpy()
    want = np.asarray(_round_call(ns["mk"](variant), rb, nb, rounds)(
        cand, tris))
    got = PK.round_probe(w["cand"], w["tris"], variant).numpy()
    np.testing.assert_array_equal(got, want)
    if variant in ("mtonly", "dynmt"):
        assert (got == 0).all()        # min(0, t > EPS or 1e30), as on TPU
    else:
        assert (got != 0).all()


@pytest.mark.parametrize("subblocks", [1, 2])
def test_round_probe_subblocks_match_micro_super(subblocks):
    """micro_super.py's kernel (dynmt without the t > EPS test) at 1 and
    2 sub-blocks per grid step; sub-blocks do not change the output."""
    k2, rb, rounds, tot = 16, 8, 2, 4
    ns = scratch_defs("micro_super.py", ["mk"], K2=k2, T=T, RB=rb, R=rounds)
    w = micro_round.workload("cpu", nb=tot, rounds=rounds, k2=k2)
    want = np.asarray(_round_call(ns["mk"](subblocks), subblocks * rb,
                                  tot // subblocks, rounds)(
        w["cand"].numpy(), w["tris"].numpy()))
    got = PK.round_probe(w["cand"], w["tris"], "dynmt_noeps",
                         subblocks=subblocks).numpy()
    np.testing.assert_allclose(got, want, rtol=T_TOL, atol=T_TOL)
    assert (got <= 0).all()


# ---- smoke kernels ----------------------------------------------------

def _pallas_smoke_gather(w) -> np.ndarray:
    """pallas_smoke.py's kernel on the inputs ``w``, in interpret mode."""
    ns = scratch_defs("pallas_smoke.py", ["kernel"], RT=64, T=T)
    nb = w["cid"].shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((1, 1, T), lambda b, cid: (cid[b], 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((64, 8), lambda b, cid: (b, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((64, 1), lambda b, cid: (b, 0),
                               memory_space=pltpu.VMEM),
    )
    f = pl.pallas_call(
        ns["kernel"],
        out_shape=jax.ShapeDtypeStruct((nb * 64, 1), jnp.float32),
        grid_spec=grid_spec, interpret=True)
    return np.asarray(f(*(w[k].numpy() for k in ("cid", "table", "rays"))))


def test_smoke_gather_matches_pallas_smoke():
    w = feature_smoke.gather_inputs("cpu")
    want = _pallas_smoke_gather(w)
    got = PK.smoke_gather(w["cid"], w["table"], w["rays"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, feature_smoke.gather_want(w))


def _lane_products(w):
    """Each ray's 128 products x * row[l], float32 [NB * 64, 128]."""
    nb = w["cid"].shape[0]
    x = w["rays"][:, 0].numpy().reshape(nb, PK.SMOKE_RT, 1)
    row = w["table"].numpy()[w["cid"].numpy(), 0][:, None, :]
    return (x * row).reshape(nb * PK.SMOKE_RT, T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smoke_gather_random_matches_pallas_smoke(seed):
    """On normal inputs the Pallas kernel's jnp.sum adds the lanes in
    another order than the plain version (lane order), so the two differ
    by rounding only: within 2 (n - 1) u sum |x row[l]| for n = 128 lanes
    (the forward error bound of a float32 sum in any order, u = 2^-24,
    once for each order) plus one rounding each of the final + 4."""
    w = feature_smoke.gather_random_inputs("cpu", seed)
    want = _pallas_smoke_gather(w)
    got = PK.smoke_gather(w["cid"], w["table"], w["rays"]).numpy()
    u = 2.0 ** -24
    mag = np.abs(_lane_products(w)).sum(axis=1, keepdims=True)
    tol = 2 * (T - 1) * u * mag + 2 * u * np.abs(want)
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("inputs", ["script", "random"])
def test_smoke_gather_plain_adds_lanes_in_order(inputs):
    """smoke_gather_plain equals a float32 numpy loop that adds the lanes
    in order, bit for bit.  On the random inputs (the ones the card test
    holds the kernel to) the reversed order gives other bits: a kernel that
    reordered the sum would fail that hold."""
    w = (feature_smoke.gather_inputs("cpu") if inputs == "script"
         else feature_smoke.gather_random_inputs("cpu"))
    prods = _lane_products(w)
    acc = np.zeros(prods.shape[0], np.float32)
    for lane in range(T):
        acc = acc + prods[:, lane]
    want = (acc + np.float32(PK.SMOKE_TRIPS))[:, None]
    got = PK.smoke_gather_plain(w["cid"], w["table"], w["rays"]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    rev = np.zeros(prods.shape[0], np.float32)
    for lane in reversed(range(T)):
        rev = rev + prods[:, lane]
    differs = ((rev + np.float32(PK.SMOKE_TRIPS))[:, None] != got).any()
    assert differs == (inputs == "random")


def test_smoke_rank_select_matches_pallas_smoke2():
    ns = scratch_defs("pallas_smoke2.py", ["kernel"])
    w = feature_smoke.rank_select_inputs("cpu")
    f = pl.pallas_call(
        ns["kernel"],
        out_shape=jax.ShapeDtypeStruct((1, T), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)
    want = np.asarray(f(w["mask"].numpy(), w["table"].numpy()))
    got = PK.smoke_rank_select(w["mask"], w["table"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, feature_smoke.rank_select_want(w))
    # a denser random mask and table, ranks past one warp
    rng = np.random.default_rng(4)
    mask = (rng.random((8, T)) < 0.2).astype(np.float32)
    table = rng.normal(size=(T, 1, T)).astype(np.float32)
    want = np.asarray(f(mask, table))
    got = PK.smoke_rank_select(torch.tensor(mask), torch.tensor(table))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(feature_smoke.RANK_SELECT_DENSITIES))
def test_smoke_rank_select_random_matches_pallas_smoke2(name):
    """The masks the card test holds the kernel to (5%, 20%, every column and
    no column set; entries exactly 0.5, which is not set, and the next
    float above it), on a normal table: pallas_smoke2.py's kernel in
    interpret mode adds in ascending columns as the plain version does,
    so the two agree bit for bit."""
    ns = scratch_defs("pallas_smoke2.py", ["kernel"])
    w = feature_smoke.rank_select_random_inputs(
        "cpu", density=feature_smoke.RANK_SELECT_DENSITIES[name])
    mask, table = w["mask"].numpy(), w["table"].numpy()
    n = int((mask > 0.5).any(axis=0).sum())
    assert n == {"5%": 40, "20%": 106, "all": T, "none": 0}[name]
    if name != "all":
        assert (mask == 0.5).any()
    if name != "none":
        assert (mask == np.nextafter(np.float32(0.5), np.float32(1))).any()
    f = pl.pallas_call(
        ns["kernel"],
        out_shape=jax.ShapeDtypeStruct((1, T), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)
    want = np.asarray(f(mask, table))
    got = PK.smoke_rank_select(w["mask"], w["table"])
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "none":
        assert not np.signbit(got.numpy()).any()   # +0.0, as 0.0f starts


@pytest.mark.parametrize("inputs", ["script", "random"])
def test_smoke_rank_select_plain_adds_columns_in_order(inputs):
    """smoke_rank_select_plain equals a float32 numpy loop that adds the
    set columns' rows in ascending order, bit for bit.  On the random
    inputs (the 5% mask the card test holds the kernel to) the reversed order
    gives other bits, on the script's arange table it does not: only the
    random table catches a kernel that reordered the sum."""
    w = (feature_smoke.rank_select_inputs("cpu") if inputs == "script"
         else feature_smoke.rank_select_random_inputs("cpu"))
    mask, table = w["mask"].numpy(), w["table"].numpy()
    cols = np.nonzero((mask > 0.5).any(axis=0))[0]
    acc = np.zeros(T, np.float32)
    for c in cols:
        acc = acc + table[c, 0]
    got = PK.smoke_rank_select_plain(w["mask"], w["table"]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, acc[None])
    rev = np.zeros(T, np.float32)
    for c in cols[::-1]:
        rev = rev + table[c, 0]
    assert (rev != acc).any() == (inputs == "random")


def test_feature_smoke_rank_select_notes():
    """hold_random runs its holds on CPU tensors (the plain versions on
    both sides); its note and the by-mask line name every mask of row 11
    with its set columns."""
    feature_smoke.hold_random("cpu")
    note = feature_smoke.hold_random_note()
    assert "5% 40, 20% 106, all 128, none 0" in note
    by_mask = {name: (n, 1e-3 * (1 + i)) for i, (name, n) in enumerate(
        (("5%", 40), ("20%", 106), ("all", T), ("none", 0)))}
    line = feature_smoke.by_mask_note(by_mask, {"device_ms": 1e-3})
    assert "5% (40 set columns) 1.00 us, 1.00x" in line
    assert "none (0 set columns) 4.00 us, 4.00x" in line


@pytest.mark.parametrize("feature", list(PK.MOSAIC_FEATURES))
def test_mosaic_probe_matches_probe_mosaic(feature):
    ns = scratch_defs("probe_mosaic.py", ["kernel"], FEAT=feature)
    w = feature_smoke.mosaic_inputs("cpu")
    f = pl.pallas_call(
        ns["kernel"],
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2
        + [pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, T), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, T), jnp.float32)],
        interpret=True)
    # the script's inputs, then a random predicate and a loop that stops
    # early (a column max <= -1 ends the while loop)
    w2 = feature_smoke.mosaic_random_inputs("cpu", len(feature))
    for ns_, cand, x in ((w[k].numpy() for k in ("ns", "cand", "x")),
                         (w2[k].numpy() for k in ("ns", "cand", "x"))):
        want = np.asarray(f(ns_, cand, x))
        got = PK.mosaic_probe(torch.tensor(ns_), torch.tensor(cand),
                              torch.tensor(x), feature)
        np.testing.assert_array_equal(got.numpy(), want)


# ---- list kernels: kernel_shape_bench.py / phase_bench4.py / chunk ----

@pytest.fixture(scope="module")
def wavefront():
    """A sorted surface wavefront on a small dragon scene, its per-ray
    lists (maxc 12) and block lists (maxc 16, 32 rays a block)."""
    scene = procedural.dragon_scene(2_000, with_sky=False, device="cpu")
    cs = scene.clusters
    o, d, tl = surface_wavefront(scene.triangles.numpy(), 128, "cpu")
    tl[::5] = 1.0                                 # some short limits
    perm = torch.argsort(PL._ray_sort_key(cs, o, d), stable=True)
    o, d, tl = o[perm], d[perm], tl[perm]
    cand, ctn, _ = PC.candidate_clusters(cs, o, d, tl, 12, exact=True)
    candg, ctng, _, _ = PC.candidate_clusters_grouped(
        cs, o, d, tl, 16, 32, exact=True, ray_cert=True)
    k2 = cs.num_clusters
    return dict(k2=k2, rays=pack_rays(o, d, tl), cand=cand, ctn=ctn,
                candg=candg, ctng=ctng, tris=PL._tiles_with_dummy(cs))


def _per_ray_pallas(w, rb, inkred):
    """_list_kernel_impl over rb-ray grid steps, as kernel_shape_bench.py:
    77-145 builds it (with the lane min inside when ``inkred``)."""
    cand = dummy_lists(w["cand"], w["k2"]).numpy()
    ctn = w["ctn"].numpy()
    rays, tris = w["rays"].numpy(), w["tris"].numpy()
    b, maxc = cand.shape
    impl = functools.partial(JL._list_kernel_impl, maxc=maxc, interpret=True)
    in_specs = [
        pl.BlockSpec((rb, maxc), lambda i: (i, 0), memory_space=pltpu.SMEM),
        pl.BlockSpec((rb, maxc), lambda i: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((rb, 8), lambda i: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec(memory_space=pltpu.VMEM),
    ]
    if inkred:
        def kern(cand_s, ctn_ref, rays_ref, tris_ref, t_out, at_ref, ar_ref,
                 stk_ref):
            impl(cand_s, ctn_ref, rays_ref, tris_ref, at_ref, ar_ref, stk_ref)
            t_out[:] = jnp.min(at_ref[:], axis=1, keepdims=True)

        return np.asarray(pl.pallas_call(
            kern, grid=(b // rb,), in_specs=in_specs,
            out_specs=pl.BlockSpec((rb, 1), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((b, 1), jnp.float32),
            scratch_shapes=[pltpu.VMEM((rb, T), jnp.float32),
                            pltpu.VMEM((rb, T), jnp.int32),
                            pltpu.VMEM((9, rb, T), jnp.float32)],
            interpret=True,
        )(cand, ctn, rays, tris))[:, 0]
    spec = pl.BlockSpec((rb, T), lambda i: (i, 0), memory_space=pltpu.VMEM)
    at, ar = pl.pallas_call(
        impl, grid=(b // rb,), in_specs=in_specs, out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((b, T), jnp.float32),
                   jax.ShapeDtypeStruct((b, T), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((9, rb, T), jnp.float32)],
        interpret=True,
    )(cand, ctn, rays, tris)
    return np.asarray(at), np.asarray(ar)


def _per_ray_vs_pallas(w, rb):
    """The guarded per-ray kernel (plain version on CPU) at ``rb`` rays
    per CUDA block against _list_kernel_impl in interpret mode at RB =
    ``rb`` rays per grid step, which runs no guard, on each ray's list cut
    at the port's stop.  Returns (at, ar, stop, count)."""
    cnd = dummy_lists(w["cand"], w["k2"])
    at, ar, stop = PL.list_tiles(cnd, w["ctn"].contiguous(), w["rays"],
                                 w["tris"], rays_per_block=rb)
    cut = torch.where(torch.arange(cnd.shape[1])[None] < stop[:, None],
                      w["cand"], -1)
    want_at, want_ar = _per_ray_pallas(dict(w, cand=cut), rb, inkred=False)
    np.testing.assert_array_equal(ar.numpy(), want_ar)
    np.testing.assert_allclose(at.numpy(), want_at, rtol=T_TOL, atol=T_TOL)
    return at, ar, stop, PL.list_counts(cnd, w["k2"])


@pytest.mark.parametrize("rb", [8, 16, 32])
def test_list_tiles_rays_per_block_matches_pallas(wavefront, monkeypatch,
                                                  rb):
    """The per-ray kernel at the TPU's RB rays per grid step against the
    port's per-ray kernel at as many rays per CUDA block, on each ray's
    list cut at the port's stop."""
    monkeypatch.setattr(JL, "RB", rb)
    _at, ar, stop, count = _per_ray_vs_pallas(wavefront, rb)
    assert (ar >= 0).any()
    fired = stop < count
    assert ((stop[fired] - PL.GROUP) % PL.CHUNK == 0).all()


def test_list_tiles_min_matches_pallas(wavefront, monkeypatch):
    monkeypatch.setattr(JL, "RB", 8)
    want = _per_ray_pallas(wavefront, 8, inkred=True)
    w = wavefront
    got = PK.list_tiles_min(dummy_lists(w["cand"], w["k2"]), w["rays"],
                            w["tris"])
    np.testing.assert_allclose(got.numpy(), want, rtol=T_TOL, atol=T_TOL)
    assert (got < BIG_T).any() and (got == BIG_T).any()


def _block_pallas(cand_rows, ctn_rows, rays, tris, k2):
    """_block_kernel_impl over every block, with the count column and the
    8-row granules, as chunk_bench_r4.py:55-111 builds it."""
    g, maxc = cand_rows.shape
    cnt = (cand_rows >= 0).sum(axis=1).astype(np.int32)
    cand_k = np.concatenate(
        [np.where(cand_rows >= 0, cand_rows, k2), cnt[:, None]],
        axis=1).astype(np.int32)
    gpad = -g % 8
    if gpad:
        cand_k = np.concatenate(
            [cand_k, np.concatenate([np.full((gpad, maxc), k2, np.int32),
                                     np.zeros((gpad, 1), np.int32)], 1)])
        ctn_rows = np.concatenate(
            [ctn_rows, np.full((gpad, maxc), BIG_T, np.float32)])
    kernel = functools.partial(JL._block_kernel_impl, maxc=maxc, rb=32,
                               interpret=True)
    spec = pl.BlockSpec((32, T), lambda b: (b, 0), memory_space=pltpu.VMEM)
    at, ar = pl.pallas_call(
        kernel, grid=(g,),
        in_specs=[
            pl.BlockSpec((8, maxc + 1), lambda b: (b // 8, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((8, maxc), lambda b: (b // 8, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((32, 8), lambda b: (b, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((g * 32, T), jnp.float32),
                   jax.ShapeDtypeStruct((g * 32, T), jnp.int32)),
        interpret=True,
    )(cand_k, ctn_rows, rays, tris)
    return np.asarray(at), np.asarray(ar)


def _block_vs_pallas(cand, ctn, rays, tris, k2):
    """The guarded block kernel (plain version on CPU) against
    _block_kernel_impl in interpret mode, which runs no guard, on each
    list cut at the port's stop.  Returns (stop, count) per block."""
    cnd = dummy_lists(torch.tensor(cand), k2)
    at, ar, stop = PL.block_tiles(cnd, torch.tensor(ctn), rays, tris)
    cut = np.where(np.arange(cand.shape[1])[None] < stop.numpy()[:, None],
                   cand, -1)
    want_at, want_ar = _block_pallas(cut, ctn, rays.numpy(), tris.numpy(), k2)
    np.testing.assert_array_equal(ar.numpy(), want_ar)
    np.testing.assert_allclose(at.numpy(), want_at, rtol=T_TOL, atol=T_TOL)
    return stop.numpy(), PL.list_counts(cnd, k2).numpy()


@pytest.mark.parametrize("lists", ["real", "all_full", "half"])
def test_block_tiles_count_lists_match_pallas(wavefront, lists):
    """The block-shared kernel on real union lists and on chunk_bench_r4's
    synthetic all-full and half-count lists (entry-t 0: the guard never
    fires on them)."""
    w = wavefront
    cand = w["candg"].numpy().copy()
    ctn = w["ctng"].numpy().copy()
    g, maxc = cand.shape
    if lists != "real":
        n = maxc if lists == "all_full" else maxc // 2
        cand = np.full((g, maxc), -1, np.int32)
        cand[:, :n] = np.arange(n, dtype=np.int32) % w["k2"]
        ctn = np.zeros((g, maxc), np.float32)
    stop, _count = _block_vs_pallas(cand, ctn, w["rays"], w["tris"], w["k2"])
    if lists != "real":
        assert (stop == maxc).all()


@pytest.fixture(scope="module")
def guarded():
    """Rays that the tail guard stops: sorted rays from outside a small
    dragon scene aimed at its triangles, a third of them any-hit rays with
    a t_lim past their target, and their block lists (maxc 48)."""
    scene = procedural.dragon_scene(6_000, with_sky=False, device="cpu")
    cs = scene.clusters
    rng = np.random.default_rng(5)
    n = 256
    tris = scene.triangles.numpy()
    target = tris[rng.integers(0, tris.shape[0], n)].mean(axis=1)
    o = target + rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + 1.0
    d = target - o
    dist = np.linalg.norm(d, axis=-1)
    d = (d / dist[:, None]).astype(np.float32)
    ah = rng.random(n) < 1 / 3
    tl = np.where(ah, dist * 1.5, BIG_T).astype(np.float32)
    o, d, tl = (torch.tensor(x) for x in (o, d, tl))
    perm = torch.argsort(PL._ray_sort_key(cs, o, d), stable=True)
    o, d, tl, ah = o[perm], d[perm], tl[perm], torch.tensor(ah)[perm]
    cand, ctn, _, _ = PC.candidate_clusters_grouped(
        cs, o, d, tl, 48, 32, exact=True, ray_cert=True)
    lcand, lctn, _ = PC.candidate_clusters(cs, o, d, tl, 48, exact=True)
    rays = torch.cat([o, d, tl[:, None], ah[:, None].float()], dim=1)
    return dict(k2=cs.num_clusters, rays=rays.contiguous(), cand=cand,
                ctn=ctn, lcand=lcand, lctn=lctn,
                tris=PL._tiles_with_dummy(cs))


def _winner(at, ar, tmin):
    """The reduction tail's (lane, round) winner: smallest lane at the
    min, then its round (lane-major pack)."""
    return torch.where(at <= tmin[:, None], torch.arange(T) * 128 + ar,
                       1 << 30).amin(dim=1)


def _assert_guard_keeps_answers(kernel, cand, ctn, rays, tris):
    """The guarded kernel against a run where the guard never fires
    (entry-t -inf, no any-hit flag): a closest-hit ray keeps its nearest t
    and (lane, round) winner, an any-hit ray its "blocked"."""
    at, ar, _ = kernel(cand, ctn, rays, tris)
    at0, ar0, stop0 = kernel(
        cand, torch.full_like(ctn, -float("inf")),
        torch.cat([rays[:, :7], torch.zeros_like(rays[:, 7:])], 1), tris)
    assert (stop0 == cand.shape[1]).all()
    ah = rays[:, 7] > 0
    tmin, tmin0 = at.amin(dim=1), at0.amin(dim=1)
    assert torch.equal(tmin[~ah], tmin0[~ah])
    assert torch.equal(_winner(at, ar, tmin)[~ah],
                       _winner(at0, ar0, tmin0)[~ah])
    assert torch.equal((tmin < rays[:, 6])[ah], (tmin0 < rays[:, 6])[ah])
    assert (tmin < rays[:, 6])[ah].any()


def _assert_stops_at_chunk_starts(stop, count, maxc):
    fired = stop < count
    assert fired.any()
    assert ((stop[fired] - PL.GROUP) % PL.CHUNK == 0).all()
    assert (stop[~fired] == maxc).all()


def test_block_tiles_guard_matches_pallas_on_cut_lists(guarded):
    """The guard fires on these lists, and what the guarded kernel computes
    is the unguarded TPU kernel's answer on each list cut at the stop."""
    g = guarded
    stop, count = _block_vs_pallas(g["cand"].numpy(), g["ctn"].numpy(),
                                   g["rays"], g["tris"], g["k2"])
    _assert_stops_at_chunk_starts(stop, count, g["cand"].shape[1])
    _assert_guard_keeps_answers(PL.block_tiles, dummy_lists(g["cand"],
                                                            g["k2"]),
                                g["ctn"], g["rays"], g["tris"])


def test_list_tiles_guard_matches_pallas_on_cut_lists(guarded, monkeypatch):
    """The per-ray guard fires on these rays' own lists (maxc 48), each
    ray stops only at a chunk start below its count, and what the guarded
    kernel computes is the unguarded TPU kernel's answer on each list cut
    at its stop."""
    g = guarded
    monkeypatch.setattr(JL, "RB", 8)
    w = dict(g, cand=g["lcand"], ctn=g["lctn"])
    _at, _ar, stop, count = _per_ray_vs_pallas(w, 8)
    _assert_stops_at_chunk_starts(stop, count, g["lcand"].shape[1])
    _assert_guard_keeps_answers(PL.list_tiles, dummy_lists(g["lcand"],
                                                           g["k2"]),
                                g["lctn"].contiguous(), g["rays"], g["tris"])


def test_list_tiles_plain_grouping_is_invisible(wavefront):
    """list_tiles_plain run block by block, as the kernel at each
    rays_per_block walks the rays (the last block ragged, each block's
    rounds only up to its own last live one), gives the same at / ar /
    stop as one call, since the guard is per ray; so does the CPU wrapper
    at every rays_per_block."""
    w = wavefront
    cand = dummy_lists(w["cand"], w["k2"])[:100].contiguous()
    ctn = w["ctn"][:100].contiguous()
    rays = w["rays"][:100].contiguous()
    one = PL.list_tiles_plain(cand, ctn, rays, w["tris"])
    for k in PL.LIST_RAYS_PER_BLOCK[1:]:
        parts = [PL.list_tiles_plain(cand[i:i + k], ctn[i:i + k],
                                     rays[i:i + k], w["tris"])
                 for i in range(0, cand.shape[0], k)]
        for j in range(3):
            assert torch.equal(torch.cat([p[j] for p in parts]), one[j])
        out = PL.list_tiles(cand, ctn, rays, w["tris"], rays_per_block=k)
        assert all(torch.equal(a, b) for a, b in zip(out, one))


# ---- wrappers, bounds, workloads --------------------------------------

def test_probe_wrappers_dispatch_on_device(wavefront):
    """CPU tensors run the plain versions and count no launch; asking for
    the CUDA kernel with CPU tensors raises; bad arguments raise."""
    w = wavefront
    cand = dummy_lists(w["cand"], w["k2"])
    PK.reset_launch_counts()
    assert torch.equal(PK.list_tiles_min(cand, w["rays"], w["tris"]),
                       PK.list_tiles_min_plain(cand, w["rays"], w["tris"]))
    sm = feature_smoke.gather_inputs("cpu")
    PK.smoke_gather(sm["cid"], sm["table"], sm["rays"])
    assert set(PK.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        PK.list_tiles_min(cand, w["rays"], w["tris"], impl="cuda")
    with pytest.raises(ValueError):
        PK.smoke_gather(sm["cid"], sm["table"], sm["rays"], impl="cuda")
    mr = micro_round.workload("cpu", nb=2, rounds=2, k2=8)
    with pytest.raises(ValueError):
        PK.round_probe(mr["cand"], mr["tris"], "dynmt", subblocks=4)
    with pytest.raises(ValueError):
        PK.round_probe(mr["cand"], mr["tris"], "copy")
    with pytest.raises(TypeError):
        PK.round_probe(mr["cand"].long(), mr["tris"], "dynmt")
    with pytest.raises(ValueError):
        PL.list_tiles(cand, w["ctn"], w["rays"], w["tris"],
                      rays_per_block=4)
    with pytest.raises(ValueError):
        PL.list_tiles_info(rays_per_block=4)
    mo = feature_smoke.mosaic_inputs("cpu")
    with pytest.raises(ValueError):
        PK.mosaic_probe(mo["ns"], mo["cand"], mo["x"], "loop")


def test_launch_floor_references_need_cuda():
    """The empty kernel and the ladder's rungs have no plain version: a
    CPU device or CPU tensors raise, and nothing is counted."""
    PK.reset_launch_counts()
    with pytest.raises(ValueError):
        PK.null_launch("cpu")
    idx = torch.zeros(1, dtype=torch.int32)
    src = torch.ones((2, T))
    out = torch.empty(T)
    for rung in PK.FLOOR_RUNGS:
        with pytest.raises(ValueError):
            PK.floor_rung(rung, idx, src, out)
    with pytest.raises(ValueError):
        PK.floor_rung(4, idx, src, out)
    with pytest.raises(ValueError):
        PK.floor_rung(1, idx, src, out[:-1])
    assert set(PK.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", list(PK.LAUNCHES))
def test_call_counts_launches_and_raises_on_errors(name, monkeypatch):
    """_call passes its arguments and the device's current stream to
    srt_<name>, counts one launch when it returns 0, and raises without
    counting on a CUDA error code; the library is a stand-in here."""
    calls = []

    class Lib:
        rc = 0

        def __getattr__(self, attr):
            def fn(*args):
                calls.append((attr, args))
                return Lib.rc
            return fn

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(PK, "_lib", Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    PK.reset_launch_counts()
    PK._call(name, "cuda", 7, 8)
    assert calls == [(f"srt_{name}", (7, 8, 1234))]
    assert PK.LAUNCHES[name] == 1
    Lib.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PK._call(name, "cuda", 7, 8)
    assert PK.LAUNCHES[name] == 1
    PK.reset_launch_counts()


def test_bounds_count_live_work():
    """Operations count only live rounds; bytes count what the output
    depends on: each named tile once, the 7 ray columns the list kernels
    read, every output once."""
    k2 = 3
    tris = torch.zeros((k2 + 1, 9, T))
    cand = torch.tensor([[0, 1, k2, k2], [1, k2, k2, k2]], dtype=torch.int32)
    rays = torch.zeros((64, 8))
    ops, nbytes = bounds.block_tiles_work(cand, rays, tris)
    assert ops == 3 * T * (bounds.EDGE_OPS + 32 * bounds.MT8_OPS)
    assert nbytes == 8 * 4 + 64 * 7 * 4 + 2 * bounds.TILE_BYTES + 64 * T * 8
    ops, nbytes = bounds.list_tiles_work(cand, rays[:2], tris)
    assert ops == 3 * T * (bounds.EDGE_OPS + bounds.MT8_OPS)
    # with the guard's stop: the live rounds before it, the tiles they
    # name, the entry-t of each check and the stop written; stop = maxc
    # gives the unguarded rounds
    long = torch.full((2, 32), k2, dtype=torch.int32)
    long[0, :30] = torch.arange(30) % k2          # count 30
    long[1, :5] = 1                               # count 5
    tris2 = torch.zeros((k2 + 1, 9, T))
    rays2 = torch.zeros((64, 8))
    full = torch.tensor([32, 32], dtype=torch.int32)
    ops_all, by_all = bounds.block_tiles_work(long, rays2, tris2)
    assert bounds.block_tiles_work(long, rays2, tris2, full)[0] == ops_all
    assert bounds.rounds_run(long, tris2, full) == 35
    per_round = T * (bounds.EDGE_OPS + 32 * bounds.MT8_OPS)
    assert ops_all == 35 * per_round
    stop = torch.tensor([24, 32], dtype=torch.int32)
    ops, nbytes = bounds.block_tiles_work(long, rays2, tris2, stop)
    assert bounds.rounds_run(long, tris2, stop) == 29
    assert ops == 29 * per_round
    # block 0 checks at 8 and 24 (fired), block 1 (count 5) never checks
    assert nbytes == by_all + 2 * 4 + 2 * 4
    # the per-ray kernel: the same rounds and checks, one ray per list
    ops_l, by_l = bounds.list_tiles_work(long, rays2[:2], tris2, stop)
    ops_l_all, by_l_all = bounds.list_tiles_work(long, rays2[:2], tris2)
    assert ops_l == 29 * T * (bounds.EDGE_OPS + bounds.MT8_OPS)
    assert ops_l_all == 35 * T * (bounds.EDGE_OPS + bounds.MT8_OPS)
    assert by_l == by_l_all + 2 * 4 + 2 * 4
    assert by_l_all == (2 * 32 * 4 + 2 * 7 * 4 + 3 * bounds.TILE_BYTES
                        + 2 * T * 8)
    ms, by = bounds.bound(67e9, 0)
    assert by == "operations" and ms == pytest.approx(1.0)
    assert bounds.bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")
    # the copy rounds read plane 0, lane 0 of each tile they name
    rc = torch.tensor([[0, 5], [5, 5]], dtype=torch.int32)
    rt = torch.zeros((8, 9, T))
    assert bounds.round_probe_work(rc, rt, "dyncopy")[1] == 4 * 4 + 2 * 4 + 8
    assert bounds.round_probe_work(rc, rt, "statcopy")[1] == 4 + 8
    assert bounds.round_probe_work(rc, rt, "dynmt")[1] == (
        4 * 4 + 2 * bounds.TILE_BYTES + 8)
    # smoke_gather reads column 0 of rays and the rows cid names
    g = feature_smoke.gather_inputs("cpu")
    n = g["rays"].shape[0]
    assert bounds.smoke_gather_work(g["cid"], g["table"], g["rays"])[1] == (
        8 * 4 + n * 4 + 8 * T * 4 + n * 4)
    # mosaic_probe: the while loop ends after the first round whose column
    # max is <= -1; with when it reads the cand columns of those rounds
    mo = feature_smoke.mosaic_inputs("cpu")
    x = mo["x"].clone()
    x[:, 2] = -5.0
    assert bounds.mosaic_probe_rounds(mo["ns"], x, "all") == 3
    assert bounds.mosaic_probe_rounds(mo["ns"], x, "while") == 5
    assert bounds.mosaic_probe_rounds(mo["ns"], x, "ds") == 4
    assert bounds.mosaic_probe_work(mo["ns"], mo["cand"], x, "all")[1] == (
        4 + 8 * T * 4 + 8 * 3 * 4 + 8 * T * 4)


def test_round_probe_time_check():
    """The time floor, now mtonly's alone (its zeroed tile gives 1e30
    from any initial value, so no value shows its work): it passes the
    times as measured and raises when mtonly runs as fast as statcopy.
    dynmt overlapping its copy (as fast as dyncopy) is no fault: the
    exact check holds its work."""
    times = dict(dyncopy=0.3096, statcopy=0.1067, mtonly=0.2282,
                 dynmt=0.3644, dynmt_noeps=0.3614)
    micro_round.time_check(times)
    micro_round.time_check(dict(times, dynmt=0.3096, dynmt_noeps=0.3096))
    with pytest.raises(RuntimeError, match="mtonly"):
        micro_round.time_check(dict(times, mtonly=0.09))


def test_round_probe_exact_check(monkeypatch):
    """The exact check passes kernels equal to the plain version at +inf
    and raises on a kernel that skipped a round."""
    w = micro_round.workload("cpu", nb=32, rounds=3, k2=16)
    micro_round.exact_check(w["cand"], w["tris"])
    real = PK.round_probe

    def one_round_short(cand, tris, variant, subblocks=1, impl=None,
                        init=0.0):
        if impl == "plain":
            return real(cand, tris, variant, impl="plain", init=init)
        return real(cand[:, :-1].contiguous(), tris, variant, subblocks,
                    init=init)

    monkeypatch.setattr(PK, "round_probe", one_round_short)
    with pytest.raises(RuntimeError, match="differs"):
        micro_round.exact_check(w["cand"], w["tris"])


@pytest.mark.parametrize("variant", micro_round.MT_VARIANTS)
def test_round_probe_init_inf(variant):
    """From an initial 0 an MT variant's output is min(0, its output from
    +inf), which is the least synthetic t over lanes and rounds: finite,
    non-zero and not constant for dynmt."""
    w = micro_round.workload("cpu", nb=4, rounds=4, k2=16)
    cand, tris = w["cand"], w["tris"]
    zero = PK.round_probe_plain(cand, tris, variant)
    inf = PK.round_probe_plain(cand, tris, variant, init=float("inf"))
    assert torch.equal(zero, torch.minimum(torch.zeros_like(inf), inf))
    assert torch.equal(PK.round_probe(cand, tris, variant, 2,
                                      init=float("inf")), inf)
    if variant == "dynmt":
        assert torch.isfinite(inf).all() and (inf != 0).all()
        assert inf.unique().numel() > 1
    if variant == "mtonly":
        assert (inf == 1e30).all()          # the zeroed tile never hits


def _union_scene(k2: int, n: int, seed: int = 3):
    """k2 tiles of random triangles in a unit box (plus the zero dummy)
    and n rays from a sphere of radius 3 toward the box: many hits."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (k2, 1, 3, T))
    tri = a + rng.normal(scale=0.25, size=(k2, 3, 3, T))
    tris = np.concatenate([tri.reshape(k2, 9, T),
                           np.zeros((1, 9, T))]).astype(np.float32)
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.4, 0.4, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tl = np.full((n, 1), BIG_T)
    tl[::4] = 3.0                                     # some short limits
    rays = np.concatenate([o, d, tl, np.zeros((n, 1))], axis=1)
    return (torch.tensor(rays, dtype=torch.float32),
            torch.tensor(tris))


def _union_walk(cand, rays, tris, rb):
    """The union walk's order: per block of rb rays, each distinct listed
    tile in ascending id, tested only for the rays whose list names it.
    Returns (t [n], tiles staged)."""
    dummy = tris.shape[0] - 1
    at = rays[:, 6:7].expand(-1, T).clone()
    staged = 0
    for b0 in range(0, cand.shape[0], rb):
        blk = cand[b0:b0 + rb]
        for u in torch.unique(blk).tolist():
            if u == dummy:
                continue
            staged += 1
            rows = b0 + torch.nonzero((blk == u).any(dim=1)).flatten()
            r = rays[rows]
            t = PL._mt8(*[tris[u, c][None] for c in range(9)],
                        *[r[:, c:c + 1] for c in range(7)])
            at[rows] = torch.where(t < at[rows], t, at[rows])
    return at.amin(dim=1), staged


@pytest.mark.parametrize("case", ["twice", "all_dummy_block", "ragged",
                                  "maxc128"])
def test_list_tiles_min_union_order(case):
    """The union walk's order gives list_tiles_min_plain's bits: a list
    naming a tile twice, a block of empty lists, a ragged last block,
    maxc 128 (4 slots a lane); its staged tiles are bounds.union_tiles'."""
    rb, k2 = PK.LIST_MIN_RAYS, 40
    n = {"ragged": 2 * rb + 5}.get(case, 3 * rb)
    maxc = 128 if case == "maxc128" else 10
    rays, tris = _union_scene(k2, n)
    rng = np.random.default_rng(7)
    cand = rng.integers(0, k2, (n, maxc))
    cand[rng.random((n, maxc)) < 0.3] = k2            # dummy slots
    if case == "twice":
        cand[:, 1] = cand[:, 0]
    if case == "all_dummy_block":
        cand[rb:2 * rb] = k2
    cand = torch.tensor(cand, dtype=torch.int32)
    want = PK.list_tiles_min_plain(cand, rays, tris)
    got, staged = _union_walk(cand, rays, tris, rb)
    assert torch.equal(got, want)
    assert torch.equal(PK.list_tiles_min(cand, rays, tris), want)
    assert (want < BIG_T).any()
    live, union = bounds.union_tiles(cand, k2, rb)
    assert union == staged and live == int((cand != k2).sum())
    if case == "all_dummy_block":
        assert torch.equal(want[rb:2 * rb], rays[rb:2 * rb, 6])


def test_chunk_workload_small():
    """The count-list sweep's lists at a small size: real union lists and
    synthetic ones with the counts the script used."""
    w = chunk.workload("cpu", n_tris=2_000, n_rays=256)
    g = 256 // PL.RB_SHARE
    counts = {k: int((v >= 0).sum(dim=1).max())
              for k, (v, _t) in w["lists"].items()}
    assert counts["synthetic all-full (96 rounds)"] == chunk.MAXC
    assert counts["synthetic count=48"] == 48
    assert counts["synthetic count=24"] == 24
    assert all(v.shape == t.shape == (g, chunk.MAXC)
               for v, t in w["lists"].values())
    cand, ctn = w["lists"]["real union lists"]
    at, _ar, stop = PL.block_tiles(dummy_lists(cand, w["k2"]), ctn,
                                   w["rays"], w["tris"])
    assert (at < BIG_T).any() and stop.shape == (g,)


# ---- the entry points run on the card unless asked for the CPU --------

ENTRY_POINTS = {
    "dragon_scene": (procedural.dragon_scene, lambda f, **kw: f(
        64, with_sky=False, **kw)),
    "make_materials": (pscene.make_materials, lambda f, **kw: f(
        [(0, 0, 0)], [(1, 1, 1)], [0.0], [1.0], **kw)),
    "make_scene": (pscene.make_scene, lambda f, **kw: f(
        np.zeros((2, 3, 3), np.float32), [0, 0], pscene.make_materials(
            [(0, 0, 0)], [(1, 1, 1)], [0.0], [1.0], device="cpu"), **kw)),
    "Camera.create": (pcam.Camera.create, lambda f, **kw: f(45.0, **kw)),
    "build_clusters": (PC.build_clusters, lambda f, **kw: f(
        procedural.dragon_standin(256), order="morton", **kw)),
    **{f"camera {name}": (fn, lambda f, **kw: f(**kw))
       for name, fn in pcam.PRESETS.items()},
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(fn)
    out = call(fn, device="cpu")                  # asked for: the CPU
    assert out is not None


def test_frame_profile_report_and_triangle_count(monkeypatch):
    """probes/frame.py: the report names the top device ops with their
    share of the frame's device time; --tris reaches the scene, and the
    profile needs the card."""
    from sycl_ray_tracing_tpu_torch.probes import frame

    prof = dict(kernels={"block_tiles_kernel": (2, 1.5, 1.0)},
                top=[(3.0, 4, "void elementwise_kernel<float>"),
                     (1.0, 2, "block_tiles_kernel")],
                device_ms=6.0, wall_ms=60.0)
    lines = frame.report(prof, "profiled", "card")
    assert any("top device op 1: 3.0000 ms (50.0% of device time), 4 "
               "launches: void elementwise_kernel<float>" in x for x in lines)
    assert lines[-1].endswith("(device busy 10.0%) (card)")
    seen = []
    monkeypatch.setattr(procedural, "dragon_scene",
                        lambda n, **kw: seen.append(n) or 1 / 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        frame.main(["--tris", "870000"])
    monkeypatch.setattr("sycl_ray_tracing_tpu_torch.probes.common."
                        "require_cuda", lambda: "cpu")
    monkeypatch.setattr("sycl_ray_tracing_tpu_torch.probes.common."
                        "card_line", lambda: "card")
    with pytest.raises(ZeroDivisionError):
        frame.main(["--tris", "870000"])
    assert seen == [870_000]


def test_kernel_ms_profiles_again_when_the_profiler_saw_no_launch(
        monkeypatch):
    """kernel_ms: a profiled run that recorded none or only some of its
    launches (or no device time) is run again; a kernel never seen with
    all its launches raises instead of averaging what the profiler saw."""
    from sycl_ray_tracing_tpu_torch.probes import frame

    readings = [(0, 0.0, 0.0), (5, 0.0, 0.0), (4, 2.0, 0.6), (5, 2.0, 0.6)]
    calls = []

    def fake(fn, kernels, warmup=False):
        assert warmup       # each run after the profiler's warm-up cycle
        fn()
        return {"kernels": {kernels[0]: readings.pop(0)}}

    monkeypatch.setattr(frame, "profile", fake)
    assert frame.kernel_ms(lambda: calls.append(1), "k", reps=5,
                           tries=4) == 0.4
    assert len(calls) == 1 + 4 * 5 and readings == []
    readings[:] = [(0, 0.0, 0.0), (4, 2.0, 0.6), (3, 1.0, 0.5)]
    with pytest.raises(RuntimeError, match=r"all 5 launches of k with "
                       r"their device time in any of 3 runs \(launches "
                       r"seen: \[0, 4, 3\]\)"):
        frame.kernel_ms(lambda: None, "k", reps=5)


def test_frame_build_ms_records_and_restores(monkeypatch):
    """build_ms replays the candidate builds a render called (here one
    grouped main pass) and puts the list tracer's functions back.  (The
    profile records the card's activity; here it only runs the replay.)"""
    from sycl_ray_tracing_tpu_torch.probes import frame

    replayed = []

    def replay(fn, kernels):
        replayed.extend(fn())
        return dict(device_ms=1.0)

    monkeypatch.setattr(frame, "profile", replay)
    cs = PC.build_clusters(procedural.dragon_standin(2_000), order="morton",
                           device="cpu")
    rng = np.random.default_rng(0)
    o = torch.tensor(rng.uniform(-0.2, 0.2, (64, 3)), dtype=torch.float32)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(64, 1)
    builds = frame.build_ms(lambda: PL.closest_hit(cs, o, d))
    assert builds["candidate_clusters_grouped"] == (1, 1.0)
    assert len(replayed) == 1 and len(replayed[0]) == 4
    assert set(builds) <= set(frame.BUILDS)
    assert PL.candidate_clusters_grouped is PC.candidate_clusters_grouped


# ---- on a card: each probe kernel against its plain twin ----------------

@pytest.fixture(scope="module")
def shape_work(card):
    """kernel_shape's sorted 98,304-ray surface wavefront over the 200k
    dragon on the card, with its per-ray and block lists."""
    from sycl_ray_tracing_tpu_torch.probes import kernel_shape

    with torch.no_grad():
        return kernel_shape.workload(main_tile(card)[0])


@pytest.mark.card
@pytest.mark.parametrize("rays_per_block", [None, *PL.LIST_RAYS_PER_BLOCK],
                         ids=lambda k: "block_tiles" if k is None
                         else f"list_tiles rays_per_block={k}")
def test_list_kernels_equal_plain_on_kernel_shape(shape_work,
                                                  rays_per_block):
    """block_tiles on the maxc-96 block lists, list_tiles at each rays per
    block on the maxc-32 lists: bit for bit, the guard stopping lists."""
    from sycl_ray_tracing_tpu_torch.probes import kernel_shape

    w = shape_work
    if rays_per_block is None:
        cand, ctn = kernel_shape.block_lists(w, kernel_shape.SHARE_MAXC)
        args = (cand, ctn, w["rays"], w["tris"])
        got, want = PL.block_tiles_cuda(*args), PL.block_tiles_plain(*args)
    else:
        cand, ctn = kernel_shape.per_ray_lists(w, 32)
        args = (cand, ctn, w["rays"], w["tris"])
        got = PL.list_tiles_cuda(*args, rays_per_block)
        want = PL.list_tiles_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (want[2] < PL.list_counts(cand, w["k2"])).any()


@pytest.mark.card
@pytest.mark.parametrize("maxc", [32, 48])
def test_list_tiles_min_equals_plain_on_the_card(shape_work, maxc):
    """The union walk on the wavefront's per-ray lists."""
    from sycl_ray_tracing_tpu_torch.probes import kernel_shape

    cand, _ctn = kernel_shape.per_ray_lists(shape_work, maxc)
    args = (cand, shape_work["rays"], shape_work["tris"])
    assert torch.equal(PK.list_tiles_min(*args),
                       PK.list_tiles_min_plain(*args))


@pytest.mark.card
@pytest.mark.parametrize("variant", PK.ROUND_VARIANTS)
def test_round_probe_equals_plain_on_the_card(card, variant):
    """The synthetic round at 1 / 8 / 32 sub-blocks from the probes'
    initial 0 and, for the MT variants, from +inf (the least t over lanes
    and rounds: a skipped lane or round shows)."""
    w = micro_round.workload(card)
    inits = ((0.0, micro_round.INF) if variant in micro_round.MT_VARIANTS
             else (0.0,))
    for init in inits:
        want = PK.round_probe(w["cand"], w["tris"], variant, impl="plain",
                              init=init)
        for sb in micro_round.SUBBLOCKS:
            got = PK.round_probe(w["cand"], w["tris"], variant, sb,
                                 init=init)
            assert torch.equal(got, want), (init, sb)


@pytest.mark.card
def test_round_probe_sass_keeps_the_mt_work(card):
    """nvcc kept an MT body per lane of the thread in each MT variant
    (sass_check raises where it did not)."""
    micro_round.sass_check()


@pytest.mark.card
def test_feature_smokes_equal_plain_on_random_inputs(card):
    """Every smoke kernel on seeded random inputs where the lanes' order
    and the while loop's early stop show (hold_random raises)."""
    feature_smoke.hold_random(card)


SCRIPT_SMOKES = ["smoke_gather", "smoke_rank_select",
                 *(f"mosaic_probe {f}" for f in PK.MOSAIC_FEATURES)]


@pytest.mark.card
@pytest.mark.parametrize("kernel", SCRIPT_SMOKES)
def test_feature_smokes_equal_plain_on_the_scripts_inputs(card, kernel):
    """On the scripts' inputs, against the twins and closed forms."""
    if kernel == "smoke_gather":
        w = feature_smoke.gather_inputs(card)
        args, want = ((w["cid"], w["table"], w["rays"]),
                      feature_smoke.gather_want(w))
        fn = PK.smoke_gather
    elif kernel == "smoke_rank_select":
        w = feature_smoke.rank_select_inputs(card)
        args, want = ((w["mask"], w["table"]),
                      feature_smoke.rank_select_want(w))
        fn = PK.smoke_rank_select
    else:
        w = feature_smoke.mosaic_inputs(card)
        args = (w["ns"], w["cand"], w["x"], kernel.split()[1])
        want, fn = None, PK.mosaic_probe
    out = fn(*args)
    assert torch.equal(out, fn(*args, impl="plain"))
    assert want is None or torch.equal(out, want)
