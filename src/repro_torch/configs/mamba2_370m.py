"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060].
The JAX package's ``repro.configs.mamba2_370m``."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=50280, ssm_state=128, ssm_expand=2,
        ssm_head_dim=64, ssm_chunk=256, conv_width=4,
        tie_embeddings=True, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, max_seq_len=1 << 20,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=64, ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=8, vocab_size=512, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 16 microbatches."""
    kw.setdefault("microbatches", 16)
    return make_train_config(sync_mode="sparcml", peak_lr=6e-4, **kw)
