"""One rank of a multi-process test of the port's parallel package.

Run as: python tests/torch_distributed_worker.py <task> <rank> <world>
<port> <dir>

Every rank joins a gloo process group on 127.0.0.1:<port> through
``parallel.distributed.initialize(device="cpu")``, builds the mesh with
the sample axis that <dir>/task.json names, runs <task> and saves what it
got to <dir>/rank<rank>.npz:

  * ``render_sharded``: the scene of <dir>/scene.npz (scene_from_numpy's
    arrays), or with ``"dragon"`` in task.json the port's own
    dragon_scene(n) with a sky of ``sky_res``; saves the image and the
    rank's mesh coordinates;
  * ``train_step``: one make_train_step call on the scene of
    <dir>/scene.npz with the diffuse albedo raised by 0.2 (clamped) as
    the guess; saves the loss and the gradients.
"""

import json
import os
import sys


def main():
    task, rank, world, port, out = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4],
                                    sys.argv[5])
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from sycl_ray_tracing_tpu_torch.models.camera import PRESETS
    from sycl_ray_tracing_tpu_torch.models.scene import scene_from_numpy
    from sycl_ray_tracing_tpu_torch.ops import rng
    from sycl_ray_tracing_tpu_torch.parallel import distributed
    from sycl_ray_tracing_tpu_torch.parallel.mesh import make_mesh
    from sycl_ray_tracing_tpu_torch.parallel.render import (
        make_train_step,
        render_sharded,
    )
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    with open(os.path.join(out, "task.json")) as f:
        spec = json.load(f)
    dev = distributed.initialize(f"127.0.0.1:{port}", world, rank,
                                 device="cpu")
    assert dev.type == "cpu"
    assert distributed.is_coordinator() == (rank == 0)
    assert distributed.process_info()["process_count"] == world
    mesh = make_mesh(world, spec["sample_axis"])
    cfg = RenderConfig(**spec["config"])
    cam = PRESETS[spec["camera"]]("cpu")
    key = rng.prng_key(spec["seed"])
    if "dragon" in spec:
        scene = dragon_scene(spec["dragon"], with_sky=True,
                             sky_res=tuple(spec["sky_res"]), device="cpu")
    else:
        scene = scene_from_numpy(dict(np.load(os.path.join(out,
                                                           "scene.npz"))),
                                 "cpu")
    got = dict(coords=np.array([mesh.data_index, mesh.sample_index]))
    if task == "render_sharded":
        got["image"] = render_sharded(scene, cam, cfg, key, mesh).numpy()
    elif task == "train_step":
        step = make_train_step(scene, cfg, mesh, optimize_env=True)
        ys, xs = torch.meshgrid(torch.arange(cfg.height, dtype=torch.float32),
                                torch.arange(cfg.width, dtype=torch.float32),
                                indexing="ij")
        mats = scene.materials
        guess = type(mats)(mats.emission,
                           torch.clamp(mats.diffuse + 0.2, 0.0, 1.0),
                           mats.metalness, mats.roughness)
        sky = scene.env_map.image
        loss, (g_mats, g_env) = step(guess, sky, mats, sky, cam,
                                     xs.reshape(-1), ys.reshape(-1), key)
        got.update(loss=loss.numpy(), env=g_env.numpy(),
                   **{f"mat_{k}": getattr(g_mats, k).numpy()
                      for k in ("emission", "diffuse", "metalness",
                                "roughness")})
    else:
        raise ValueError(f"unknown task {task!r}")
    np.savez(os.path.join(out, f"rank{rank}.npz"), **got)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: ok")


if __name__ == "__main__":
    main()
