from repro_torch.kernels.qsgd_unpack.ops import qsgd_unpack  # noqa: F401
