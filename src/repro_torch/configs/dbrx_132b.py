"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752(per-expert)
vocab=100352, MoE 16 experts top-4 (fine-grained) [hf:databricks/dbrx-base].
The JAX package's ``repro.configs.dbrx_132b``.

At full scale this model needs FSDP placement, and per-rank EF residuals
do not compose with it, so its ``train_config`` asks for dense sync with
``fsdp=True``; SparCML runs on its smoke config. The port has no fsdp yet,
so ``train_config`` raises (ROADMAP Queue 1, item 10 — fsdp)."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=10752, vocab_size=100352,
        num_experts=16, experts_per_token=4, moe_d_ff=10752,
        capacity_factor=1.25, rope_theta=500000.0,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        max_seq_len=32768,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512, num_experts=4,
                  experts_per_token=2, moe_d_ff=128, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=128)


def train_config(**kw):
    kw.setdefault("opt_dtype", torch.bfloat16)
    kw.setdefault("microbatches", 8)
    return make_train_config(sync_mode="dense", fsdp=True, peak_lr=1e-4,
                             **kw)
