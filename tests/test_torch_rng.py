"""The port's threefry RNG against jax.random, bit for bit, and the port's
import boundary (the package never imports jax)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.models import pathtracer as jax_pt
from sycl_ray_tracing_tpu_torch.ops import rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_bits(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 5, 42, 2**31 - 1])
def test_prng_key_and_fold_chains(seed):
    k_j = jax.random.PRNGKey(seed)
    k_p = rng.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(k_j, np.int64), k_p.numpy())
    for chain in [(0,), (3, 1), (7, 0, 2), (2**32 - 1, 12345)]:
        kj, kp = k_j, k_p
        for c in chain:
            kj = jax.random.fold_in(kj, c)
            kp = rng.fold_in(kp, c)
        np.testing.assert_array_equal(np.asarray(kj, np.int64), kp.numpy())


@pytest.mark.parametrize("cols", [2, 3])
@pytest.mark.parametrize("w", [1, 7, 256, 4099])
def test_uniform_bit_exact(w, cols):
    for seed, chain in [(0, ()), (11, (4,)), (42, (1, 5))]:
        kj, kp = jax.random.PRNGKey(seed), rng.prng_key(seed)
        for c in chain:
            kj, kp = jax.random.fold_in(kj, c), rng.fold_in(kp, c)
        _same_bits(jax.random.uniform(kj, (w, cols), jnp.float32),
                   rng.uniform(kp, (w, cols), "cpu"))


@pytest.mark.parametrize("bounce,tag", [(0, 0), (0, 5), (3, 1), (7, 3)])
def test_pathtracer_uniforms(bounce, tag):
    """rng.uniforms == pathtracer._uniforms: fold_in(fold_in(key, bounce),
    tag) then uniform — the per-bounce, per-purpose streams."""
    kj = jax.random.fold_in(jax.random.PRNGKey(9), 2)   # a tile/sample fold
    kp = rng.fold_in(rng.prng_key(9), 2)
    _same_bits(jax_pt._uniforms(kj, bounce, tag, (300, 2)),
               rng.uniforms(kp, bounce, tag, (300, 2), "cpu"))


def test_draws_depend_only_on_flat_index():
    """A (4096,2) draw's first rows equal a (512,2) draw: why the compacted
    wavefront's width buckets do not change a lane's samples."""
    k = rng.fold_in(rng.prng_key(1), 3)
    big = rng.uniform(k, (4096, 2), "cpu")
    small = rng.uniform(k, (512, 2), "cpu")
    assert torch.equal(big[:512], small)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sycl_ray_tracing_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('sycl_ray_tracing_tpu.')"
        " or m == 'sycl_ray_tracing_tpu']\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules"
        " if m.startswith('sycl_ray_tracing_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
