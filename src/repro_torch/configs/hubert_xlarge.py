"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only (wav2vec2-style backbone) [arXiv:2106.07447].
The JAX package's ``repro.configs.hubert_xlarge``.

The conv waveform frontend is a STUB: the batch carries precomputed frame
embeddings (B, S, 512). No decode (encoder-only)."""
import torch

from repro_torch.configs._common import make_train_config
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    kw = dict(
        name="hubert-xlarge", family="encoder",
        num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
        head_dim=80, d_ff=5120, vocab_size=504, causal=False,
        frontend_dim=512, act_fn="gelu",
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, max_seq_len=32768,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return config(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                  head_dim=16, d_ff=128, vocab_size=96, frontend_dim=32,
                  dtype=torch.float32, param_dtype=torch.float32,
                  max_seq_len=128)


def train_config(**kw):
    """SparCML (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1), 8 microbatches."""
    kw.setdefault("microbatches", 8)
    return make_train_config(sync_mode="sparcml", peak_lr=5e-4, **kw)
