"""Packed ELP_BSD execution: the two Hopper kernels, their plain versions and wrappers."""
