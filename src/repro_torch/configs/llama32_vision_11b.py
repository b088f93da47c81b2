"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].
The JAX package's ``repro.configs.llama32_vision_11b``.

Text backbone only; the vision frontend is a STUB: the batch carries
precomputed patch embeddings (B, 1600, 1280). Cross-attention blocks every
5 layers (8 in all, as in the 11B release)."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="llama-3.2-vision-11b", family="vlm",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=128256,
        cross_attn_every=5, num_image_tokens=1600, vision_dim=1280,
        rope_theta=500000.0, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, max_seq_len=131072,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=10, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512, cross_attn_every=5,
                  num_image_tokens=16, vision_dim=48, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 8 microbatches."""
    kw.setdefault("microbatches", 8)
    return make_train_config(sync_mode="sparcml", peak_lr=1e-4, **kw)
