"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm + GQA [hf:Qwen/Qwen3-8B family].
The JAX package's ``repro.configs.qwen3_4b``."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="qwen3-4b", family="dense",
        num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=9728, vocab_size=151936, qk_norm=True,
        rope_theta=1000000.0, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, max_seq_len=131072,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 8 microbatches."""
    kw.setdefault("microbatches", 8)
    return make_train_config(sync_mode="sparcml", peak_lr=3e-4, **kw)
