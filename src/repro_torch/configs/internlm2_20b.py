"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297].
The JAX package's ``repro.configs.internlm2_20b``."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="internlm2-20b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92544,
        rope_theta=1000000.0, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, max_seq_len=131072,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=96, num_heads=6, num_kv_heads=2,
                  head_dim=16, d_ff=192, vocab_size=512, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 4 microbatches."""
    kw.setdefault("microbatches", 4)
    return make_train_config(sync_mode="sparcml", peak_lr=2e-4, **kw)
