"""Neural building blocks: RMSNorm, RoPE, GQA attention (training,
prefill, KV-cache decode with an optional sliding-window ring), the vlm's
gated cross-attention, SwiGLU/GELU MLP.

Parameters are plain dicts of tensors in the JAX package's layout
(``repro.models.layers``): x @ W with W of shape (in, out). Attention
switches where the reference's does: below sequence 2048 (or at a length
that is not whole 1024-key chunks) it is the plain path (matmuls and an
f32 softmax over the whole (S, T) scores); from there it is the
reference's ``flash_attention``, an online softmax over 1024-key chunks
whose backward recomputes each chunk's scores from the saved log-sum-exp,
so no (S, T) tensor is built or saved in either direction. Training
takes it as an ``autograd.Function`` (``_FlashAttention``); the prefill
calls its forward alone.

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


def _repeat_kv(cfg: ModelConfig, k, v):
    """GQA: each of k's and v's heads repeated num_heads / num_kv_heads
    times (outside the chunked path's Function, as the reference's repeat
    lies outside its custom VJP: the repeated heads' gradients sum back
    through autograd)."""
    g = cfg.num_heads // cfg.num_kv_heads
    if g == 1:
        return k, v
    return (torch.repeat_interleave(k, g, dim=2),
            torch.repeat_interleave(v, g, dim=2))


def _chunked(s: int) -> bool:
    """Whether a sequence of ``s`` takes the chunked path (the
    reference's switch)."""
    return s >= _CHUNKED_MIN and s % _KEY_CHUNK == 0


def attention(p, cfg: ModelConfig, x, positions, *, causal=True
              ) -> torch.Tensor:
    """Full-sequence attention (training, the encoder). positions: (S,);
    the plain path also takes (B, S)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if _chunked(s):
        if positions.dim() != 1:
            raise ValueError("the chunked attention takes one (S,) row of "
                             f"positions, not {tuple(positions.shape)}")
        kr, vr = _repeat_kv(cfg, k, v)
        out = flash_attention(q, kr, vr, positions, causal,
                              cfg.sliding_window, _KEY_CHUNK)
        return out.reshape(b, s, -1) @ p["wo"]
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


def _chunk_scores(q, kc_, qpos, kp, causal: bool, window: int, scale):
    """One key chunk's scaled f32 scores (B, nh, S, C), -1e30 where the
    mask (causal, and the sliding window when set) hides a key. The
    product is taken in f32 of upcast operands (exact products, f32 sums:
    the reference's ``preferred_element_type=f32``), as every chunk
    product here is."""
    f32 = torch.float32
    scores = torch.einsum("bsnh,bcnh->bnsc", q.to(f32), kc_.to(f32)) * scale
    if causal or window:
        mask = (qpos >= kp[None, :]) if causal else torch.ones(
            (q.shape[1], kc_.shape[1]), dtype=torch.bool, device=q.device)
        if window:
            mask = mask & (qpos - kp[None, :] < window)
        scores = torch.where(mask, scores, -1e30)
    return scores


def _flash_fwd(q, k, v, positions, causal: bool, window: int, kc: int):
    """Online-softmax attention over key chunks of ``kc`` (the reference's
    ``_flash_fwd``): only a (B, nh, S, kc) block of scores is live at a
    time. q: (B, S, nh, hd); k/v: (B, T, nh, hd) (GQA heads repeated by
    the caller); positions: (T,). Returns the output (B, S, nh, hd) in
    q's dtype and the f32 log-sum-exp of each query's scores (B, nh, S)."""
    b, s, nh, hd = q.shape
    t = k.shape[1]
    kpos = positions.reshape(t // kc, kc)
    qpos = positions[:, None]
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    m = torch.full((b, nh, s, 1), -math.inf, dtype=f32, device=q.device)
    den = torch.zeros((b, nh, s, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, nh, s, hd), dtype=f32, device=q.device)
    q32 = q.to(f32)
    for c in range(t // kc):
        kc_, vc_ = k[:, c * kc:(c + 1) * kc], v[:, c * kc:(c + 1) * kc]
        scores = _chunk_scores(q32, kc_, qpos, kpos[c], causal, window,
                               scale)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pr = torch.exp(scores - m_new)
        den = den * corr + pr.sum(-1, keepdim=True)
        pv = torch.einsum("bnsc,bcnh->bnsh", pr.to(vc_.dtype).to(f32),
                          vc_.to(f32))
        acc = acc * corr + pv
        m = m_new
    den = torch.clamp_min(den, 1e-30)
    out = (acc / den).to(q.dtype)
    lse = (m + torch.log(den))[..., 0]
    return out.transpose(1, 2), lse


def _flash_bwd(q, k, v, positions, out, lse, dout, causal: bool,
               window: int, kc: int):
    """The reference's ``_flash_bwd``: each key chunk's scores recomputed
    with the forward's mask, p = exp(s - lse), then dv = pᵀ·dO, dp =
    dO·vᵀ, ds = p·(dp - D)·scale with D = rowsum(dO·O), dq += ds·k and dk
    = dsᵀ·q; every product in f32 of upcast operands, ds rounded to k's
    and q's dtype before its two products, so bf16 rounds where the
    reference rounds. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    b, s, nh, hd = q.shape
    t = k.shape[1]
    kpos = positions.reshape(t // kc, kc)
    qpos = positions[:, None]
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    q32, dout32 = q.to(f32), dout.to(f32)
    d = torch.einsum("bsnh,bsnh->bns", dout32, out.to(f32))
    dq = torch.zeros((b, s, nh, hd), dtype=f32, device=q.device)
    dks, dvs = [], []
    for c in range(t // kc):
        kc_, vc_ = k[:, c * kc:(c + 1) * kc], v[:, c * kc:(c + 1) * kc]
        kc32 = kc_.to(f32)
        scores = _chunk_scores(q32, kc32, qpos, kpos[c], causal, window,
                               scale)
        pr = torch.exp(scores - lse[..., None])               # (B,nh,S,C)
        dvs.append(torch.einsum("bnsc,bsnh->bcnh", pr, dout32))
        dp = torch.einsum("bsnh,bcnh->bnsc", dout32, vc_.to(f32))
        ds = pr * (dp - d[..., None]) * scale
        dq = dq + torch.einsum("bnsc,bcnh->bsnh",
                               ds.to(kc_.dtype).to(f32), kc32)
        dks.append(torch.einsum("bnsc,bsnh->bcnh", ds.to(q.dtype).to(f32),
                                q32))
        del scores, pr, dp, ds        # before the next chunk's are made
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: saves q, k, v,
    positions, the output and the log-sum-exp (nothing of size S x T) and
    recomputes the scores chunk by chunk in the backward. ``setup_context``
    and the generated vmap rule let it run under ``torch.func.vmap`` and
    ``grad`` (the training step's rank grads) and inside a remat block's
    ``torch.func.vjp``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, positions, causal, window, kc):
        return _flash_fwd(q, k, v, positions, causal, window, kc)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, positions, causal, window, kc = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, positions, out, lse)
        ctx.cfg = (causal, window, kc)

    @staticmethod
    def backward(ctx, dout, _dlse):
        # no graph: under torch.func.grad the backward runs with
        # create_graph, and a graph of this loop would hold every chunk's
        # (B, nh, S, kc) intermediates alive until the loop ends
        with torch.no_grad():
            grads = _flash_bwd(*ctx.saved_tensors, dout, *ctx.cfg)
        return grads + (None,) * 4


def flash_attention(q, k, v, positions, causal: bool, window: int,
                    kc: int) -> torch.Tensor:
    """Online-softmax attention with a recomputing backward. q: (B, S, nh,
    hd); k/v: (B, T, nh, hd), GQA heads repeated by the caller;
    positions: (T,). Returns (B, S, nh, hd)."""
    return _FlashAttention.apply(q, k, v, positions, causal, window, kc)[0]


def attention_prefill(p, cfg: ModelConfig, x, positions, cache_len: int):
    """Forward over the prompt; returns (out, KVCache padded to cache_len).

    RoPE is applied to K at write time, so decode never re-rotates the
    cache. With a sliding window the cache is a ring of width
    w = min(cache_len, window) holding position i at slot i % w."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if _chunked(s):
        kr, vr = _repeat_kv(cfg, k, v)
        out, _ = _flash_fwd(q, kr, vr, positions, True, cfg.sliding_window,
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
