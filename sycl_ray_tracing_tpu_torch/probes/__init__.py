"""The list tracer's cost-law probes on the card, the counterparts of the
TPU probe scripts in scratch/ (python -m sycl_ray_tracing_tpu_torch.probes).
"""
