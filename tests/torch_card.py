"""What the port's on-card tests share.  Such a test carries the
``card`` marker and takes the ``card`` fixture, directly or through a
module fixture that builds its inputs, so that without a card it skips
before anything is built.  On a card:

    python -m pytest -o addopts="" -m card tests/test_torch_*.py
"""

import contextlib
import socket

import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt

KERNELS = ("block_tiles", "list_tiles")
# the main path's frame: 512x512 pixels, 32768-ray tiles, 8 bounces
W = H = 512
TILE = 32768
BOUNCES = 8


@pytest.fixture(scope="session")
def card():
    """The CUDA card; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def main_tile(device):
    """The 200k dragon with its sky on ``device``, and what render_rays
    takes for the first tile of its 512x512 frame: (scene, camera, px,
    py, key)."""
    from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing_tpu_torch.ops import rng
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    pix = torch.arange(TILE, device=device)
    return (dragon_scene(200_000, with_sky=True, device=device),
            pbrt_dragon_camera(device), (pix % W).float(),
            (pix // W).float(), rng.fold_in(rng.prng_key(0), 0))


def tile_both(scene, cam, px, py, key, **kw):
    """A tile of the 512x512 frame at 8 bounces through render_rays, with
    the kernels and with their plain twins: the two (radiance, aux) and
    the kernels' launches."""
    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt

    lt.reset_launch_counts()
    with torch.no_grad():
        out = [pt.render_rays(scene, cam, px, py, W, H, key, 1, BOUNCES,
                              with_aux=True, impl=impl, **kw)
               for impl in (None, "plain")]
    return out, dict(lt.LAUNCHES)


def aimed_rays(tris, n=8192):
    """``n`` rays from a box around the mesh ``tris`` [N,3,3] (numpy)
    toward random triangles' centroids: float32 (o, d, distance)."""
    rng = np.random.default_rng(0)
    lo, hi = tris.min(axis=(0, 1)), tris.max(axis=(0, 1))
    o = rng.uniform(1.5 * lo - 0.5 * hi, 1.5 * hi - 0.5 * lo, (n, 3))
    d = tris[rng.integers(0, tris.shape[0], n)].mean(axis=1) - o
    dist = np.linalg.norm(d, axis=-1)
    return tuple(torch.tensor(x, dtype=torch.float32)
                 for x in (o, d / dist[:, None], dist))


def assert_certified_hits_are_brute_force(scene, o, d):
    """Each certified closest hit of rays (o, d) on ``scene`` is the
    brute-force oracle's (t within 1e-5)."""
    from sycl_ray_tracing_tpu_torch.ops.intersect import intersect_triangles

    t, prim, _of, res = lt.closest_hit(scene.clusters, o, d,
                                       with_resolved=True)
    ref = intersect_triangles(o, d, scene.triangles)
    hit = ref.hit & res
    assert res.any() and hit.any()
    assert torch.equal((prim >= 0)[res], ref.hit[res])
    assert torch.equal(prim[hit], ref.prim[hit].to(prim.dtype))
    assert ((t - ref.t).abs()[hit] <= 1e-5).all()


@contextlib.contextmanager
def held_launches(first=None):
    """While open, each launch of the list tracer's kernels (up to the
    ``first`` of each) is run again by its plain twin as it happens.
    Yields {kernel: [launch]}: its rays, lists, poisoned lists (SC
    overflow), lists the guard stopped before their count, and whether
    (at, ar, stop) equal the twin's bit for bit."""
    held = {name: [] for name in KERNELS}
    orig = {name: getattr(lt, name) for name in KERNELS}

    def hold(name):
        plain = getattr(lt, f"{name}_plain")

        def wrapper(cand, ctn, rays, tris, **kw):
            out = orig[name](cand, ctn, rays, tris, **kw)
            if cand.is_cuda and kw.get("impl") in (None, "cuda") and (
                    first is None or len(held[name]) < first):
                want = plain(cand, ctn, rays, tris)
                count = lt.list_counts(cand, tris.shape[0] - 1)
                held[name].append(dict(
                    rays=rays.shape[0], lists=cand.shape[0],
                    poisoned=int((ctn[:, -1] < 0).sum()),
                    stopped=int((want[2] < count).sum()),
                    same=all(torch.equal(a, b) for a, b in zip(out, want))))
            return out
        return wrapper

    for name in KERNELS:
        setattr(lt, name, hold(name))
    try:
        yield held
    finally:
        for name, fn in orig.items():
            setattr(lt, name, fn)


@contextlib.contextmanager
def recorded_runs():
    """Records the list tracer's first two passes (``_run``: a tile's
    primary rays, its first bounce's fused query) as (*args, kwargs)."""
    runs, run = [], lt._run

    def record(*args, **kw):
        if len(runs) < 2:
            runs.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args) + (dict(kw),))
        return run(*args, **kw)

    lt._run = record
    try:
        yield runs
    finally:
        lt._run = run


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(device):
    """A one-rank NCCL group on a free local port, as torchrun starts
    one rank; the rank renders where ``device``'s tensors live."""
    import torch.distributed as dist

    from sycl_ray_tracing_tpu_torch.parallel import distributed

    rank_dev = distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                      device=device)
    try:
        assert dist.get_backend() == "nccl"
        here = torch.empty(0, device=device).device
        assert rank_dev == here, (rank_dev, here)
        yield rank_dev
    finally:
        dist.destroy_process_group()
