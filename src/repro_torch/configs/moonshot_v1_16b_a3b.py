"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16)
d_ff=1408(per-expert) vocab=163840, MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]. Shared-expert path included (2x ff).
The JAX package's ``repro.configs.moonshot_v1_16b_a3b``."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=163840,
        num_experts=64, experts_per_token=6, moe_d_ff=1408,
        moe_shared_ff=2816, capacity_factor=1.25,
        rope_theta=50000.0, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, max_seq_len=131072,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                  head_dim=16, d_ff=32, vocab_size=512, num_experts=8,
                  experts_per_token=2, moe_d_ff=32, moe_shared_ff=64,
                  dtype=torch.float32, param_dtype=torch.float32,
                  max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 4 microbatches.
    The port has no mesh: the replica count is the Trainer's."""
    kw.setdefault("microbatches", 4)
    return make_train_config(sync_mode="sparcml", peak_lr=4e-4, **kw)
