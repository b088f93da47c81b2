"""Neural building blocks: RMSNorm, RoPE, GQA attention (training,
prefill, KV-cache decode with an optional sliding-window ring), the vlm's
gated cross-attention, SwiGLU/GELU MLP.

Parameters are plain dicts of tensors in the JAX package's layout
(``repro.models.layers``): x @ W with W of shape (in, out). Training
attention is the non-chunked path of the reference (plain matmuls and an
f32 softmax). The prefill takes the reference's online-softmax chunked
form (``_flash_fwd``, forward only) from sequence 2048; its recomputing
backward, which the reference's training attention uses there, is not
ported (ROADMAP Queue 1 item 5).

Decoding writes the KV cache IN PLACE: ``attention_decode`` writes each
row's new key and value into the cache it is given and returns that same
cache, where the reference donates the cache and returns an updated copy.
A caller that needs the cache from before a step clones it first.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

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

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, W, nkv, hd): W = cache length or sliding window
    v: torch.Tensor


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


_CHUNKED_MIN = 2048   # the reference's threshold for its chunked attention
_KEY_CHUNK = 1024


def _flash_fwd(q, k, v, positions, causal: bool, window: int, kc: int):
    """Online-softmax attention over key chunks of ``kc`` (the reference's
    ``_flash_fwd``): only a (B, nh, S, kc) block of scores is live at a
    time. q: (B, S, nh, hd); k/v: (B, T, nh, hd) (GQA heads repeated by
    the caller); positions: (T,). Returns (B, S, nh, hd)."""
    b, s, nh, hd = q.shape
    t = k.shape[1]
    kpos = positions.reshape(t // kc, kc)
    qpos = positions[:, None]
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, nh, s, 1), -math.inf, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((b, nh, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nh, s, hd), dtype=torch.float32, device=q.device)
    for c in range(t // kc):
        kc_, vc_ = k[:, c * kc:(c + 1) * kc], v[:, c * kc:(c + 1) * kc]
        kp = kpos[c]
        scores = torch.einsum("bsnh,bcnh->bnsc", q, kc_).to(
            torch.float32) * scale
        mask = (qpos >= kp[None, :]) if causal else torch.ones(
            (s, kc), dtype=torch.bool, device=q.device)
        if window:
            mask = mask & (qpos - kp[None, :] < window)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pr = torch.exp(scores - m_new)
        den = den * corr + pr.sum(-1, keepdim=True)
        pv = torch.einsum("bnsc,bcnh->bnsh", pr.to(vc_.dtype), vc_).to(
            torch.float32)
        acc = acc * corr + pv
        m = m_new
    out = (acc / torch.clamp_min(den, 1e-30)).to(q.dtype)
    return out.transpose(1, 2)


def attention_prefill(p, cfg: ModelConfig, x, positions, cache_len: int):
    """Forward over the prompt; returns (out, KVCache padded to cache_len).

    RoPE is applied to K at write time, so decode never re-rotates the
    cache. With a sliding window the cache is a ring of width
    w = min(cache_len, window) holding position i at slot i % w."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if s >= _CHUNKED_MIN and s % _KEY_CHUNK == 0:
        g = cfg.num_heads // cfg.num_kv_heads
        kr = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
        vr = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
        out = _flash_fwd(q, kr, vr, positions, True, cfg.sliding_window,
                         _KEY_CHUNK)
        out = out.reshape(b, s, -1) @ p["wo"]
    else:
        i = positions[..., :, None]
        j = positions[..., None, :]
        mask = i >= j
        if cfg.sliding_window:
            mask = mask & (i - j < cfg.sliding_window)
        out = _sdpa(q, k, v, mask, cfg.head_dim) @ p["wo"]
    w = cache_len
    if cfg.sliding_window:
        w = min(w, cfg.sliding_window)
    if s >= w:                  # keep the last w entries
        if cfg.sliding_window:  # ring layout: slot = pos % w
            slots = (positions[..., -w:] % w).long()
            kk = torch.zeros((b, w) + k.shape[2:], dtype=k.dtype,
                             device=k.device)
            vv = torch.zeros_like(kk)
            kk[:, slots] = k[:, -w:]
            vv[:, slots] = v[:, -w:]
        else:
            kk, vv = k[:, s - w:].contiguous(), v[:, s - w:].contiguous()
    else:
        pad = (0, 0, 0, 0, 0, w - s)
        kk, vv = F.pad(k, pad), F.pad(v, pad)
    return out, KVCache(kk, vv)


def attention_decode(p, cfg: ModelConfig, x, cache: KVCache, pos):
    """One-token decode. x: (B, 1, d); pos: the current position, a 0-d
    int tensor (or int) for a batch-synchronous decode, or a (B,) vector
    of PER-SLOT positions (continuous batching: each request slot is at
    its own depth in its own cache rows).

    Full attention: cache slot = pos, clamped to the last slot (the
    reference's update clamps there too; in the per-slot form an inactive
    slot may sit past the cache end, and its rows are overwritten at
    admission). Sliding window: a ring, slot = pos % w. The new key and
    value are written into ``cache`` in place; returns (out, cache)."""
    b = x.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    w = cache.k.shape[1]
    q = (x @ p["wq"]).reshape(b, 1, nh, hd)
    k = (x @ p["wk"]).reshape(b, 1, nkv, hd)
    v = (x @ p["wv"]).reshape(b, 1, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if not torch.is_tensor(pos):
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    slot_ids = torch.arange(w, device=x.device)
    posv = pos[:, None] if pos.dim() == 1 else pos.reshape(1)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    slot = pos % w if cfg.sliding_window else torch.clamp_max(pos, w - 1)
    if pos.dim() == 1:
        # the same math per batch row as the scalar form: rope at each
        # row's own position, a per-row cache slot and validity mask
        bidx = torch.arange(b, device=x.device)
        cache.k[bidx, slot.long()] = k[:, 0]
        cache.v[bidx, slot.long()] = v[:, 0]
        slot, pos = slot[:, None], pos[:, None]
    else:
        cache.k.index_copy_(1, slot.reshape(1).long(), k)
        cache.v.index_copy_(1, slot.reshape(1).long(), v)
    if cfg.sliding_window:
        age = (slot - slot_ids) % w     # steps since the slot was written
        valid = age < torch.clamp_max(pos + 1, w)
    else:
        valid = slot_ids <= pos
    mask = valid[:, None, None, :] if valid.dim() == 2 else valid
    out = _sdpa(q, cache.k, cache.v, mask, hd) @ p["wo"]
    return out, cache


# -- cross-attention (vlm) ---------------------------------------------------

def cross_attn_init(generator, cfg: ModelConfig, device, lead=()) -> dict:
    d, nh, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    dt = cfg.param_dtype

    def w(shape):
        return _dense_init(generator, lead + shape, dt, None, device,
                           fan_in=shape[0])

    return {
        "wq": w((d, nh * hd)),
        "wk": w((d, nkv * hd)),
        "wv": w((d, nkv * hd)),
        "wo": w((nh * hd, d)),
        "gate": torch.zeros(lead, dtype=dt, device=device),  # tanh gate, 0
        "q_norm": rmsnorm_init(hd, dt, device, lead),
        "k_norm": rmsnorm_init(hd, dt, device, lead),
    }


def cross_kv(p, cfg: ModelConfig, kv_feats):
    """The image tokens' keys (k-normed) and values: (B, T, nkv, hd)."""
    b, t, _ = kv_feats.shape
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = (kv_feats @ p["wk"]).reshape(b, t, nkv, hd)
    v = (kv_feats @ p["wv"]).reshape(b, t, nkv, hd)
    return rmsnorm(p["k_norm"], k, cfg.norm_eps), v


def cross_attend(p, cfg: ModelConfig, x, k, v) -> torch.Tensor:
    """x: (B, S, d) text against the image keys and values, gated."""
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    q = rmsnorm(p["q_norm"], (x @ p["wq"]).reshape(b, s, nh, hd),
                cfg.norm_eps)
    mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, hd) @ p["wo"]
    return torch.tanh(p["gate"].to(torch.float32)).to(x.dtype) * out


def cross_attention(p, cfg: ModelConfig, x, kv_feats) -> torch.Tensor:
    """x: (B, S, d) text; kv_feats: (B, T_img, d) projected vision tokens."""
    k, v = cross_kv(p, cfg, kv_feats)
    return cross_attend(p, cfg, x, k, v)


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
