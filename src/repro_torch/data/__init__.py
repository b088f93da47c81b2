from repro_torch.data.pipeline import DataConfig, synthetic_batch  # noqa: F401
