"""PyTorch + CUDA port of the SparCML reproduction in ``src/repro``.

Mirrors the JAX package's subpackages (core, comm, kernels, models,
optim, data, train). It imports torch, numpy and the standard library,
never JAX or the JAX package. The four Pallas TPU kernels are
hand-written CUDA kernels for Hopper here (``kernels/``, ``csrc/``).
"""
