"""The row sum behind the gradient of a small-table row gather
(ops/kernels/rows.py): its plain version against a float64 index_add_,
gather_rows against plain indexing and its gates, the bounce's gradients
through it against plain indexing, and on a card the kernel
(csrc/row_scatter.cu) against the plain version, bit for bit.

The card tests skip without CUDA; on a card:

    python -m pytest -o addopts="" -m card tests/test_torch_row_scatter.py

This file imports no JAX: it runs on the card's machine too.

Tolerances: a sum in another float32 order than index_add_'s float64 one
is off by a few ulps of the sum of the terms' magnitudes, so each column
is held within 1e-6 of its absolute sum; a gradient through the bounce
sums such row sums with the rest of the backward, so within 1e-5 of the
largest entry of its leaf.
"""

import dataclasses

import pytest
import torch

from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models import scene as PS
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.ops import rng
from sycl_ray_tracing_tpu_torch.ops.kernels import rows as RW
from sycl_ray_tracing_tpu_torch.utils import metrics
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene
from torch_card import card  # noqa: F401

WIDTHS = (1, 255, 2048, 2049, 262_144)
SHAPES = ((4, 8), (2, 12), (2048, 8))
FIELDS = ("emission", "diffuse", "metalness", "roughness")


def _inputs(W: int, R: int, C: int, skew: bool, seed: int = 0,
            device="cpu"):
    """grad [W, C] and an int32 index [W]: uniform over the R rows, or
    skewed onto the first half of them (the rest left empty), most rays
    in row 0, as the bounce's materials are."""
    g = torch.Generator().manual_seed(seed)
    grad = torch.randn((W, C), generator=g)
    if skew:
        u = torch.rand((W,), generator=g)
        idx = torch.clamp_max((u ** 6 * max(1, R // 2)).long(),
                              max(0, R // 2 - 1))
    else:
        idx = torch.randint(0, R, (W,), generator=g)
    return grad.to(device), idx.to(torch.int32).to(device)


def _held_to_f64(out, grad, idx, R):
    ref = torch.zeros((R, grad.shape[1]), dtype=torch.float64).index_add_(
        0, idx.long(), grad.double())
    mag = torch.zeros_like(ref).index_add_(0, idx.long(), grad.double().abs())
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.all((out.double() - ref).abs() <= 1e-6 * mag)


@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("W", WIDTHS)
def test_plain_row_sum_against_float64(W, shape, skew):
    """row_sum_plain within 1e-6 of each column's absolute sum of a
    float64 index_add_; rows no ray reads sum to 0; the same bits twice."""
    R, C = shape
    grad, idx = _inputs(W, R, C, skew)
    out = RW.row_sum_plain(grad, idx, R)
    _held_to_f64(out, grad, idx, R)
    empty = torch.bincount(idx.long(), minlength=R) == 0
    if skew and R > 2:
        assert empty.any()
    assert torch.all(out[empty] == 0)
    again = RW.row_sum_plain(grad, idx, R)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_plain_row_sum_order():
    """The order is the documented one: in a chunk a row's rays by a
    pairwise tree over their rank, then the chunks in order.  Terms chosen
    so another order gives other bits: (1 + 2^-24) + ... rounds away."""
    big, tiny = 1.0, 2.0 ** -24
    vals = [big, tiny, tiny, tiny]
    grad = torch.tensor(vals, dtype=torch.float32)[:, None]
    idx = torch.zeros(4, dtype=torch.int32)
    a, b, c, d = (torch.tensor(v, dtype=torch.float32) for v in vals)
    assert RW.row_sum_plain(grad, idx, 1)[0, 0] == (a + b) + (c + d)
    # two chunks: chunk 0's partial, then chunk 1's
    W = RW.ROW_SUM_CHUNK + 1
    grad = torch.full((W, 1), tiny)
    grad[-1, 0] = big
    out = RW.row_sum_plain(grad, torch.zeros(W, dtype=torch.int64), 1)
    p0 = RW.row_sum_plain(grad[:-1], torch.zeros(W - 1, dtype=torch.int64), 1)
    assert out[0, 0] == p0[0, 0] + big


def test_plain_row_sum_counts_negative_indices_from_the_end():
    grad, idx = _inputs(300, 4, 3, skew=False, seed=3)
    neg = torch.where(idx >= 2, idx - 4, idx)
    assert torch.equal(RW.row_sum_plain(grad, neg, 4),
                       RW.row_sum_plain(grad, idx, 4))


@pytest.mark.parametrize("shape", [(4, 8), (2, 12), (5, 3)])
def test_gather_rows_against_plain_indexing(shape, monkeypatch):
    """The forward is table[idx.long()] bit for bit; the table's gradient
    agrees with plain indexing's within 1e-6; the backward is one row_sum
    and the index gets none."""
    R, C = shape
    grad, idx = _inputs(4099, R, C, skew=True, seed=R)
    idx = idx.reshape(-1, 1) if R == 5 else idx     # an index of 2 dims
    table = torch.randn((R, C), generator=torch.Generator().manual_seed(1))
    calls = []
    orig = RW.row_sum
    monkeypatch.setattr(RW, "row_sum", lambda *a: calls.append(1) or orig(*a))
    t1 = table.clone().requires_grad_()
    t2 = table.clone().requires_grad_()
    out1 = RW.gather_rows(t1, idx)
    out2 = t2[idx.long()]
    assert out1.grad_fn.name() == "_GatherRowsBackward"
    assert torch.equal(out1.view(torch.int32), out2.view(torch.int32))
    w = grad.reshape(out2.shape)
    (g1,) = torch.autograd.grad((out1 * w).sum(), t1)
    (g2,) = torch.autograd.grad((out2 * w).sum(), t2)
    assert calls == [1]
    scale = torch.zeros(R, C, dtype=torch.float64).index_add_(
        0, idx.reshape(-1).long(), w.reshape(-1, C).double().abs())
    assert torch.all((g1 - g2).double().abs() <= 1e-6 * scale)


@pytest.mark.parametrize("case", ["no_grad", "no_requires_grad",
                                  "too_many_rows", "float64"])
def test_gather_rows_gates(case, monkeypatch):
    """Under no_grad, for a table that requires no gradient, past
    ROW_SUM_MAX_ROWS rows or in another dtype, gather_rows is plain
    indexing: no Function in the graph, no row_sum, no launch counted."""
    R = RW.ROW_SUM_MAX_ROWS + 1 if case == "too_many_rows" else 4
    dtype = torch.float64 if case == "float64" else torch.float32
    table = torch.randn((R, 8), dtype=dtype)
    if case != "no_requires_grad":
        table.requires_grad_()
    idx = torch.randint(0, R, (1000,), dtype=torch.int32)
    calls = []
    monkeypatch.setattr(RW, "row_sum", lambda *a: calls.append(1))
    metrics.reset_counts()
    if case == "no_grad":
        with torch.no_grad():
            out = RW.gather_rows(table, idx)
        assert out.grad_fn is None
    else:
        out = RW.gather_rows(table, idx)
        if table.requires_grad:
            assert out.grad_fn.name() == "IndexBackward0"
            out.sum().backward()
    assert torch.equal(out, table[idx.long()])
    assert calls == []
    assert metrics.COUNTS.get("row_scatter.fused", 0) == 0


def test_row_sum_refuses_what_the_kernel_cannot_take():
    grad = torch.zeros((10, 8))
    idx = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        RW.row_sum(grad, idx, RW.ROW_SUM_MAX_ROWS + 1)
    with pytest.raises(ValueError):
        RW.row_sum(torch.zeros((10, RW.ROW_SUM_MAX_COLS + 1)), idx, 4)
    with pytest.raises(TypeError):
        RW.row_sum(grad.double(), idx, 4)
    with pytest.raises(TypeError):
        RW.row_sum(grad, idx.to(torch.int16), 4)
    with pytest.raises(ValueError):
        RW.row_sum(grad, idx[:9], 4)


@pytest.fixture(scope="module")
def scene():
    """The 2k dragon stand-in (4 materials, 2 emitters) with a small sky."""
    return dragon_scene(2000, sky_res=(16, 32), device="cpu")


def _bounce_grads(scene, estimator, min_b, monkeypatch, plain):
    """The gradients of a 2-bounce 16x16 frame's mean w.r.t. the four
    material fields, through gather_rows or (plain) through indexing, and
    the row sums the backward ran."""
    if plain:
        for mod in (PP, PS):
            monkeypatch.setattr(mod, "gather_rows", lambda t, i: t[i.long()])
    calls = []
    orig = RW.row_sum
    monkeypatch.setattr(RW, "row_sum", lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(PP, "COMPACT_MIN_B", min_b)
    leaves = {f: getattr(scene.materials, f).clone().requires_grad_()
              for f in FIELDS}
    s = scene.with_materials(dataclasses.replace(scene.materials, **leaves))
    W = H = 16
    pix = torch.arange(W * H)
    hdr = PP.render_rays(s, pbrt_dragon_camera("cpu"), (pix % W).float(),
                         (pix // W).float(), W, H, rng.prng_key(5), 1, 2,
                         backend="list", estimator=estimator)
    grads = torch.autograd.grad(hdr.mean(), [leaves[f] for f in FIELDS])
    monkeypatch.undo()
    return hdr.detach(), grads, len(calls)


@pytest.mark.parametrize("estimator,min_b", [("shared", 1 << 30),
                                             ("shared", 1),
                                             ("parity", 1 << 30)],
                         ids=["shared", "shared-compacted", "parity"])
def test_bounce_gradients_through_gather_rows(scene, estimator, min_b,
                                              monkeypatch):
    """trace_shared (unpacked and compacted) and trace at 2 bounces: the
    frame bit for bit and every material gradient within 1e-5 of its
    largest entry of plain indexing's.  Each bounce's backward runs three
    row sums: trace_shared's material, light-row and hit-emission gathers,
    trace's Materials.lookup and its two emission gathers."""
    f1, g1, n1 = _bounce_grads(scene, estimator, min_b, monkeypatch, False)
    f2, g2, n2 = _bounce_grads(scene, estimator, min_b, monkeypatch, True)
    assert (n1, n2) == (3 * 2, 0)
    assert torch.equal(f1, f2)
    assert g1[1].abs().max() > 0
    for name, a, b in zip(FIELDS, g1, g2):
        tol = 1e-5 * float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.card
@pytest.mark.parametrize("idx64", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("W", WIDTHS)
def test_kernel_equals_plain_on_a_card(card, W, shape, skew, idx64):
    """The kernel's sums bit for bit the plain version's, the same bits in
    3 runs, one launch counted a call."""
    R, C = shape
    grad, idx = _inputs(W, R, C, skew, device=card)
    if idx64:
        idx = idx.long()
    want = RW.row_sum_plain(grad.cpu(), idx.cpu(), R)
    before = metrics.COUNTS.get("row_scatter.fused", 0)
    for _ in range(3):
        got = RW.row_sum(grad, idx, R)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    assert metrics.COUNTS["row_scatter.fused"] == before + 3


@pytest.mark.card
def test_gather_rows_backward_on_a_card(card):
    """A gather's backward through gather_rows on the card at the frame's
    width: one kernel launch, the plain version's bits."""
    grad, idx = _inputs(262_144, 4, 8, True, device=card)
    table = torch.rand((4, 8), device=card, requires_grad=True)
    before = metrics.COUNTS.get("row_scatter.fused", 0)
    (g,) = torch.autograd.grad(RW.gather_rows(table, idx), table, grad)
    assert metrics.COUNTS["row_scatter.fused"] == before + 1
    want = RW.row_sum_plain(grad.cpu(), idx.cpu(), 4)
    assert torch.equal(g.cpu().view(torch.int32), want.view(torch.int32))
