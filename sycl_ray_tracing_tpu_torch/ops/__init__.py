"""Compute ops: math substrate, RNG, intersection, BRDF, sampling, env map,
cluster candidate build, and the list-tracer kernels."""
