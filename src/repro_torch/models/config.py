"""Unified architecture configuration covering all assigned families.

The port builds and runs the dense and MoE families so far; the other
families' fields are kept so a config reads the same in both packages."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # attention details
    qk_norm: bool = False           # qwen3
    rope_theta: float = 10000.0
    causal: bool = True
    sliding_window: int = 0         # 0 = full attention; >0 = windowed (hybrid long ctx)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert ffn dim (dbrx/moonshot style)
    capacity_factor: float = 1.25
    moe_shared_ff: int = 0          # moonshot has a shared expert path

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # hybrid (zamba2): shared attention block every N mamba layers
    attn_every: int = 0

    # vlm (llama-3.2-vision): cross-attention block every N layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    vision_dim: int = 0

    # encoder-only (hubert): stub frontend provides frame embeddings
    frontend_dim: int = 0           # dim of precomputed frame embeddings

    # compute / numerics
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    act_fn: str = "silu"            # silu (llama-family) | gelu (hubert)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 8192

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived ----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a 256 multiple so TP/FSDP shardings divide
        evenly (MaxText-style padding; pad logits are harmless in the
        softmax and labels never reference them)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k (sub-quadratic / bounded-state)?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp = 3 * d * ff if self.act_fn == "silu" else 2 * d * ff
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "dense" or self.family == "vlm":
            n = L * (attn + mlp) + emb
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = L // self.cross_attn_every
                n += n_cross * (attn + mlp) + self.vision_dim * d
            return n
        if self.family == "moe":
            moe = self.num_experts * 3 * d * self.moe_d_ff
            shared = 3 * d * self.moe_shared_ff if self.moe_shared_ff else 0
            router = d * self.num_experts
            return L * (attn + moe + shared + router) + emb
        if self.family in ("ssm", "hybrid"):
            di, ns, nh_s = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj -> (z, x, B, C, dt) + conv + out_proj
            mamba = (d * (2 * di + 2 * ns + nh_s)
                     + self.conv_width * (di + 2 * ns)
                     + di * d + 2 * nh_s)
            n = L * mamba + emb
            if self.family == "hybrid" and self.attn_every:
                n += attn + mlp  # one shared block
            return n
        if self.family == "encoder":
            return L * (attn + mlp) + v * d + self.frontend_dim * d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        moe_active = self.experts_per_token * 3 * d * self.moe_d_ff
        shared = 3 * d * self.moe_shared_ff if self.moe_shared_ff else 0
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + moe_active + shared + d * self.num_experts) + emb
