"""Neural building blocks of the dense LM: RMSNorm, RoPE, GQA attention,
SwiGLU/GELU MLP.

Parameters are plain dicts of tensors in the JAX package's layout
(``repro.models.layers``): x @ W with W of shape (in, out). Attention is
the non-chunked path of the reference (plain matmuls and an f32 softmax);
the reference switches to its chunked flash form only from sequence 2048.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


# -- init helpers ----------------------------------------------------------

def _dense_init(generator: Optional[torch.Generator], shape, dtype,
                scale=None, device=None, fan_in=None) -> torch.Tensor:
    """N(0, 1) * scale, scale = 1/sqrt(fan_in) by default (fan_in = the
    first dim of one layer's weight). A meta device allocates nothing."""
    fan_in = fan_in or (shape[0] if len(shape) >= 1 else 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device if generator is not None
                    else device)
    return (w * scale).to(device=device, dtype=dtype)


def rmsnorm_init(d: int, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


# -- rotary ----------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)   # (half,)
    ang = positions.to(torch.float32)[..., None] * freqs      # (..., S, half)
    ang = ang[..., :, None, :]                                # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention -------------------------------------------------------------

def attn_init(generator, cfg: ModelConfig, device, lead=()) -> dict:
    d = cfg.d_model
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)

    def w(shape, scale=None):
        return _dense_init(generator, lead + shape, cfg.param_dtype, scale,
                           device, fan_in=shape[0])

    p = {
        "wq": w((d, nh * hd)),
        "wk": w((d, nkv * hd)),
        "wv": w((d, nkv * hd)),
        "wo": w((nh * hd, d), 1.0 / math.sqrt(nh * hd * 2 * cfg.num_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, cfg.param_dtype, device, lead)
        p["k_norm"] = rmsnorm_init(hd, cfg.param_dtype, device, lead)
    return p


def _qkv(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, nh, hd)
    k = (x @ p["wk"]).reshape(b, s, nkv, hd)
    v = (x @ p["wv"]).reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, hd: int):
    """q (B,S,nh,hd), k/v (B,T,nkv,hd); GQA via KV-head repeat; f32 softmax.
    mask: (S, T) or broadcastable to (B, 1, S, T); True = attend."""
    b, s, nh, _ = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnst,btnh->bsnh", probs, v)
    return out.reshape(b, s, nh * hd)


def attention(p, cfg: ModelConfig, x, positions, *, causal=True
              ) -> torch.Tensor:
    """Full-sequence attention (training)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    i = positions[..., :, None]  # query pos
    j = positions[..., None, :]  # key pos
    mask = (i >= j) if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=x.device)
    if cfg.sliding_window:
        mask = mask & (i - j < cfg.sliding_window)
    out = _sdpa(q, k, v, mask, cfg.head_dim)
    return out @ p["wo"]


# -- MLP -------------------------------------------------------------------

def mlp_init(generator, cfg: ModelConfig, device, lead=(),
             d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    lead = tuple(lead)

    def w(shape, scale=None):
        return _dense_init(generator, lead + shape, cfg.param_dtype, scale,
                           device, fan_in=shape[0])

    p = {
        "wi": w((d, ff)),
        "wo": w((ff, d), 1.0 / math.sqrt(ff * 2 * cfg.num_layers)),
    }
    if cfg.act_fn == "silu":
        p["wg"] = w((d, ff))
    return p


def mlp(p, cfg: ModelConfig, x) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.act_fn == "silu":
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]
