"""Hand-written Hopper (sm_90a) CUDA kernels for SparCML's hot spots.

The PyTorch counterparts of the four Pallas TPU kernels in
``src/repro/kernels``:

- ``bucket_topk``    — per-bucket top-k selection + compaction + fused
                       error-feedback residual (Alg. 2 lines 1-3).
- ``bucket_scatter`` — stream densification (a direct shared-memory
                       scatter on Hopper; a one-hot contraction on the TPU);
                       ``bucket_scatter_sum`` densifies S sources and sums
                       them in source order in the same pass, grouped over
                       every bucket of a step in one launch.
- ``qsgd_pack``      — QSGD bucketed stochastic quantization + bit-packing;
                       its grouped form packs every DSAR + QSGD bucket of a
                       step in one launch, reading the summed buffers where
                       they lie.
- ``qsgd_unpack``    — inverse of qsgd_pack; its grouped form unpacks every
                       DSAR + QSGD bucket of a step in one launch and writes
                       each bucket's reduced buffer (pod sum and mean fused).

Each directory holds ``kernel.py`` (the ctypes launcher of the CUDA
source in ``src/repro_torch/csrc``), ``ops.py`` (the public wrapper:
dispatch by the tensor's device and a launch count) and ``ref.py`` (the
plain PyTorch version). ``_build.py`` compiles the sources at first use.
"""
