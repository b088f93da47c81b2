"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — WSD schedule, tied embeddings (llama-like)
[arXiv:2404.06395]. The JAX package's ``repro.configs.minicpm_2b``."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="minicpm-2b", family="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        head_dim=64, d_ff=5760, vocab_size=122753,
        tie_embeddings=True, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, max_seq_len=65536,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=72, num_heads=6, num_kv_heads=6,
                  head_dim=12, d_ff=144, vocab_size=512, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 16 microbatches,
    the arch's signature WSD schedule."""
    kw.setdefault("microbatches", 16)
    return make_train_config(sync_mode="sparcml", schedule_kind="wsd",
                             peak_lr=1e-3, **kw)
