"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (benchmark/reference), each number
beside a limit from the traffic file.

The plain reference is the configuration's estimator's:
reference/estimators/<estimator>.py under the benchmark's root.

Progressive frames: a sample of (frame, tile) pairs drawn from the seed
among the window's frames; the reference renders each tile from the
benchmark's inputs and the frame's key; ``pixels_off`` is the share of
the sampled pixels where some channel differs by more than
pixel_atol + pixel_rtol * |reference|.  ``overflow_frames`` counts the
window's frames the program did not certify exact (limit 0).

Trainer steps: the reference follows the first steps from the same start
and keys with its own renderer, autograd and Adam, and one step of the
window, drawn from the seed, from the parameters and Adam moments the
program held before it.  ``loss_gap`` is the largest relative gap of a
step's loss; ``grad_gap`` and ``change_gap`` hold, leaf by leaf, the norm
of the first gradient (from the optimizer's first moment after one step;
in the window's step, the gradient handed to the optimizer) and of the
parameters' change over the followed steps, as |program - reference|
over the larger of the leaf's reference norm and the median leaf's; the
worst leaf counts, and the worse of the two followings.  A leaf whose
reference gradient is under GRAD_FLOOR of the median leaf's is left out
of both.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import manifest
from benchmark.reference import estimators, pathtrace, rng

GRAD_FLOOR = 1e-3
MAX_BRANCHES = 8
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def frame_sample(seed: int, frames: int, tiles: int, count: int) -> list:
    """(frame, tile) pairs, ``count`` of them (or all), drawn from the
    seed without repeats."""
    total = frames * tiles
    pick = np.random.default_rng([int(seed), 0x5EED]).choice(
        total, size=min(count, total), replace=False)
    return [(int(p) // tiles, int(p) % tiles) for p in sorted(pick)]


def reference_tiles(inputs, cfg: dict, base_key, pairs, device,
                    dtype=torch.float32, rules=(False, True),
                    root=manifest.ROOT) -> dict:
    """{(frame, tile): [HDR [tile_rays, 3] on the host]} by the
    estimator's reference under ``root``: one render under the
    lower-index tie rule, and where its scene queries met a tie, a second
    under the higher (both are exact); ``rules=(False,)`` renders the
    first only."""
    render_tile = estimators.load(cfg["estimator"], root,
                                  ("render_tile",)).render_tile
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = pathtrace.Scene(inputs, device, dtype)
    out = {}
    for f, t in pairs:
        variants = []
        for high in rules:
            scene.tree.tie_high, scene.tree.ties = high, 0
            hdr = render_tile(scene, rng.fold_in(base_key, f), t,
                              cfg["tile_rays"], cfg["width"], cfg["height"],
                              cfg["bounces"])
            variants.append(hdr.float().cpu())
            if not scene.tree.ties:
                break
        scene.tree.tie_high = False
        out[(f, t)] = variants
    return out


def pixels_off(program: dict, reference: dict, cfg: dict,
               traffic: dict) -> float:
    """The share of compared pixels where the program's HDR is off the
    reference's, each tile against the reference variant it is nearer.
    ``program``: {(frame, tile): [rows, 3] host tensor}."""
    n = cfg["width"] * cfg["height"]
    tile = cfg["tile_rays"]
    bad = total = 0
    for (f, t), variants in reference.items():
        rows = min(tile, n - t * tile)
        p = program[(f, t)][:rows]
        off = []
        for ref in variants:
            r = ref[:rows]
            ok = (p - r).abs() <= traffic["pixel_atol"] + traffic[
                "pixel_rtol"] * r.abs()
            off.append(int((~ok.all(dim=1)).sum()))
        bad += min(off)
        total += rows
    return bad / total


def tile_rows(image: torch.Tensor, tile: int, tile_rays: int):
    flat = image.reshape(-1, 3)
    return flat[tile * tile_rays:(tile + 1) * tile_rays]


def window_pick(seed: int, first: int, steps: int) -> int:
    """The window's step the check follows: one of ``first`` ..
    ``first + steps - 1``, drawn from the seed."""
    return first + int(np.random.default_rng([int(seed), 0x57E9]).integers(
        steps))


def reference_steps(inputs, cfg: dict, traffic: dict, base_key, start: dict,
                    steps: int, device, dtype=torch.float32,
                    max_branches: int = MAX_BRANCHES, first: int = 0,
                    moments=None, root=manifest.ROOT) -> list:
    """The trainer of the estimator's reference under ``root`` from
    ``start`` ({"diffuse", "roughness"} host tensors) at step ``first``
    with Adam's ``moments`` ({"m", "v"}: [diffuse, roughness] host tensors
    each; zero if None), one branch per choice of tie rule for each render
    that met a tie (at most
    ``max_branches``; both rules give exact answers): [{"losses": [float],
    "grad": [diffuse, roughness] of the first step followed, "params":
    [diffuse, roughness] after ``steps``}]."""
    train_loss = estimators.load(cfg["estimator"], root,
                                 ("train_loss",)).train_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = pathtrace.Scene(inputs, device, dtype)
    lr = traffic["lr"]
    lo = (0.0, traffic["roughness_min"])
    params = [start["diffuse"].to(device, dtype).clone(),
              start["roughness"].to(device, dtype).clone()]
    if moments is None:
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
    else:
        m = [x.to(device, dtype).clone() for x in moments["m"]]
        v = [x.to(device, dtype).clone() for x in moments["v"]]
    branches = [{"params": params, "m": m, "v": v, "losses": [],
                 "grad": None}]
    for i in range(first, first + steps):
        key = rng.fold_in(base_key, i)
        grown = []
        for br in branches:
            rules = [(False, False)]
            while rules:
                rule = rules.pop(0)
                leaves = [p.detach().requires_grad_() for p in br["params"]]
                loss, ties = train_loss(scene, *leaves, key, cfg["width"],
                                        cfg["height"], cfg["bounces"], rule)
                grads = torch.autograd.grad(loss, leaves)
                grown.append(_adam(br, float(loss.detach()), grads, i + 1,
                                   lr, lo))
                if rule == (False, False) and len(branches) < max_branches:
                    rules = [r for r in ((False, True), (True, False),
                                         (True, True))
                             if (ties[0] or not r[0]) and (ties[1] or not r[1])]
                del loss, grads, leaves
        branches = grown[:max_branches]
    return [{"losses": br["losses"], "grad": br["grad"],
             "params": [p.float().cpu() for p in br["params"]]}
            for br in branches]


def _adam(br: dict, loss: float, grads, t: int, lr: float, lo) -> dict:
    """A new branch: ``br`` after one Adam step on ``grads`` and the
    clamps to [lo, 1]."""
    b1, b2 = BETAS
    out = {"losses": br["losses"] + [loss], "params": [], "m": [], "v": [],
           "grad": br["grad"] or [g.float().cpu() for g in grads]}
    with torch.no_grad():
        for j, g in enumerate(grads):
            m = b1 * br["m"][j] + (1 - b1) * g
            v = b2 * br["v"][j] + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            p = br["params"][j] - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
            out["params"].append(torch.clamp(p, lo[j], 1.0))
            out["m"].append(m)
            out["v"].append(v)
    return out


def _leaf_gap(prog, ref, keep) -> float:
    norms_r = [float(torch.linalg.vector_norm(r)) for r in ref]
    med = float(np.median(norms_r))
    gaps = []
    for p, r, nr, k in zip(prog, ref, norms_r, keep):
        if k:
            gaps.append(abs(float(torch.linalg.vector_norm(p)) - nr)
                        / max(nr, med, 1e-30))
    return max(gaps)


def step_gaps(program: dict, reference: list, start: dict,
              limits: dict) -> dict:
    """loss_gap, grad_gap and change_gap of the program's first steps
    (keys as a reference branch's) against the reference branch it is
    nearest: the one whose worst gap over its limit is least."""
    return min((_gaps(program, ref, start) for ref in reference),
               key=lambda g: max(v / limits[k] for k, v in g.items()))


def _gaps(program: dict, reference: dict, start: dict) -> dict:
    n = len(reference["losses"])
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in
                   zip(program["losses"][:n], reference["losses"]))
    gnorm = [float(torch.linalg.vector_norm(g)) for g in reference["grad"]]
    med = float(np.median(gnorm))
    keep = [g >= GRAD_FLOOR * med for g in gnorm]
    p0 = [start["diffuse"], start["roughness"]]
    change_p = [p - s for p, s in zip(program["params"], p0)]
    change_r = [p - s for p, s in zip(reference["params"], p0)]
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(program["grad"], reference["grad"], keep),
            "change_gap": _leaf_gap(change_p, change_r, keep)}
