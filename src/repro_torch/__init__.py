"""PyTorch/CUDA port of the CoNLoCNN reproduction for an NVIDIA H100.

A second package beside the JAX package ``repro`` (the reference), with
the same module names and the same tensor layouts at every public
function. It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``. The kernels (the two packed matmuls and flash attention) are
CUDA C++ for ``sm_90a`` under ``csrc/``, built with ``nvcc`` on first use
(:mod:`repro_torch._build`); each has a plain PyTorch version that runs
for tensors on the CPU.
"""
