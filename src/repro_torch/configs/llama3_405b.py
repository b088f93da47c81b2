"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783].
The JAX package's ``repro.configs.llama3_405b``.

At 405B the per-rank error-feedback residual of TopK SGD is O(model size)
per data rank, which does not compose with the ZeRO-3 placement this
model needs, so its ``train_config`` asks for dense sync with
``fsdp=True`` and bf16 optimizer state; SparCML runs on its smoke config."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="llama3-405b", family="dense",
        num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        head_dim=128, d_ff=53248, vocab_size=128256,
        rope_theta=500000.0, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, max_seq_len=131072,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=6, d_model=128, num_heads=8, num_kv_heads=2,
                  head_dim=16, d_ff=256, vocab_size=512, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=128)


def train_config(**kw):
    kw.setdefault("opt_dtype", torch.bfloat16)
    kw.setdefault("microbatches", 16)
    return make_train_config(sync_mode="dense", fsdp=True, peak_lr=8e-5,
                             **kw)
