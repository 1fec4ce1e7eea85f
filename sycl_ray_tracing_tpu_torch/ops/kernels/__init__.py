"""Hand-written GPU kernels and the host code that launches them."""
