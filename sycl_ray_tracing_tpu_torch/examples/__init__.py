"""The five BASELINE.json configurations as runnable examples
(counterparts of the repository's examples/):

    python -m sycl_ray_tracing_tpu_torch.examples.<name> [--small]

  config1_spheres_direct  spheres-only scene, direct light, 256x256 @ 16spp
  config2_obj_bvh         MIS.obj + clusters, 4 bounces, 512x512 @ 64spp
  config3_dragon_mis      dragon stand-in, GGX + MIS, 1280x720 @ 128spp
  config4_env_tonemap     dragon + HDR sky, tone mapped, 1920x1080 @ 256spp
  config5_inverse_sharded the inverse-rendering trainer, 100 steps

Each renders on the card, prints one JSON line and writes its outputs
(example1-4.png, example4.hdr) into the current directory.  ``--small``
runs the JAX examples' reduced sizes.  Each image example's ``build``
returns its scene, camera, config and key for a size and a device, and
``_common.run`` renders, checks, writes and reports it.
"""
