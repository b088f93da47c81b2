"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention block every
6 layers [arXiv:2411.15242]. The JAX package's
``repro.configs.zamba2_2p7b``.

long_context: the shared attention runs a 4096-token sliding window (ring
KV cache) so the decode state stays bounded."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(long_context: bool = False, **overrides) -> ModelConfig:
    kw = dict(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        head_dim=80, d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        attn_every=6, sliding_window=4096 if long_context else 0,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        max_seq_len=1 << 20,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                  head_dim=16, d_ff=128, ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=8, attn_every=2, vocab_size=512,
                  dtype=torch.float32, param_dtype=torch.float32,
                  max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 8 microbatches."""
    kw.setdefault("microbatches", 8)
    return make_train_config(sync_mode="sparcml", peak_lr=3e-4, **kw)
