from repro_torch.kernels.bucket_topk.ops import bucket_topk  # noqa: F401
