"""The Hopper kernels (two packed matmuls, flash attention), their plain versions and wrappers."""
