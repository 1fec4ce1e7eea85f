"""Progressive, checkpointable rendering (counterpart of
sycl_ray_tracing_tpu/models/progressive.py).

The reference cannot resume a render: its framebuffer accumulates linearly
but tone mapping immediately overwrites it in place (render_kernel.cpp:
169-180).  Here accumulation is linear and the complete renderer state is
three values:

    (hdr_sum [H,W,3], samples_done, seed)

so a render can be checkpointed after any sample batch and resumed exactly:
the counter-based RNG (threefry keyed by sample index, bit-exact with
jax.random) makes the resumed stream equal the uninterrupted one.
Checkpoints are plain .npz in the JAX package's format, so either
package resumes the other's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.models import pathtracer
from sycl_ray_tracing_tpu_torch.models.camera import Camera
from sycl_ray_tracing_tpu_torch.models.scene import Scene
from sycl_ray_tracing_tpu_torch.ops.rng import fold_in, prng_key
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig


@dataclasses.dataclass
class ProgressiveState:
    hdr_sum: np.ndarray     # [H,W,3] linear radiance SUM (not average)
    samples_done: int
    seed: int
    # True if ANY accumulated batch saw an uncertified ray or a pair-budget
    # overflow: those batches may be missing hits, so the whole
    # accumulation is suspect (main.py restarts with a grown budget)
    overflow: bool = False

    @property
    def image(self) -> np.ndarray:
        """Current linear HDR estimate (average of completed samples)."""
        return self.hdr_sum / max(1, self.samples_done)

    def save(self, path: str) -> None:
        np.savez(
            path, hdr_sum=self.hdr_sum,
            samples_done=np.int64(self.samples_done), seed=np.int64(self.seed),
            overflow=np.bool_(self.overflow),
        )

    @staticmethod
    def load(path: str) -> "ProgressiveState":
        z = np.load(path)
        return ProgressiveState(
            hdr_sum=z["hdr_sum"],
            samples_done=int(z["samples_done"]),
            seed=int(z["seed"]),
            overflow=bool(z["overflow"]) if "overflow" in z else False,
        )


class ProgressiveRenderer:
    """Accumulates sample batches; checkpoint/resume between batches.

    Every batch renders with key fold_in(prng_key(seed), samples_done), so
    sample streams are a pure function of (seed, sample index) regardless
    of interruptions.
    """

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 seed: int = 0, samples_per_batch: int = 4,
                 state: Optional[ProgressiveState] = None):
        if config.samples % samples_per_batch != 0:
            raise ValueError("samples must divide by samples_per_batch")
        self.scene = scene
        self.camera = camera
        self.config = config
        self.samples_per_batch = samples_per_batch
        self._batch_cfg = dataclasses.replace(config,
                                              samples=samples_per_batch)
        self.state = state or ProgressiveState(
            hdr_sum=np.zeros((config.height, config.width, 3), np.float32),
            samples_done=0,
            seed=seed,
        )

    @property
    def done(self) -> bool:
        return self.state.samples_done >= self.config.samples

    def step(self) -> ProgressiveState:
        """Render one sample batch and fold it into the accumulator."""
        if self.done:
            return self.state
        key = fold_in(prng_key(self.state.seed), self.state.samples_done)
        with torch.no_grad():
            batch, aux = pathtracer.render(self.scene, self.camera,
                                           self._batch_cfg, key,
                                           with_aux=True)
        self.state.hdr_sum = self.state.hdr_sum + (
            batch.cpu().numpy() * self.samples_per_batch
        )
        self.state.samples_done += self.samples_per_batch
        self.state.overflow = self.state.overflow or bool(aux["overflow"])
        return self.state

    def run(self, checkpoint_path: Optional[str] = None,
            on_batch: Optional[Callable[[ProgressiveState], None]] = None
            ) -> np.ndarray:
        """Render all remaining samples; checkpoint after each batch."""
        while not self.done:
            self.step()
            if checkpoint_path:
                tmp = checkpoint_path + ".tmp.npz"
                self.state.save(tmp)
                os.replace(tmp, checkpoint_path)
            if on_batch:
                on_batch(self.state)
        return self.state.image

    @staticmethod
    def resume(scene: Scene, camera: Camera, config: RenderConfig,
               checkpoint_path: str,
               samples_per_batch: int = 4) -> "ProgressiveRenderer":
        state = ProgressiveState.load(checkpoint_path)
        return ProgressiveRenderer(
            scene, camera, config, seed=state.seed,
            samples_per_batch=samples_per_batch, state=state,
        )
