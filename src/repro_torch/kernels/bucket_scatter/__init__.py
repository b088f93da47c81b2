from repro_torch.kernels.bucket_scatter.ops import bucket_scatter  # noqa: F401
