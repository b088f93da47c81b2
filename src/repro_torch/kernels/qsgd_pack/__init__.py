from repro_torch.kernels.qsgd_pack.ops import qsgd_pack  # noqa: F401
