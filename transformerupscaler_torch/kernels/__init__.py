"""Hand-written Hopper kernels (``csrc/``), their build and their wrappers."""
