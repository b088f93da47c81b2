"""Float32 building blocks: RMSNorm, rotary embedding (the two halves of
each head rotated), causal attention, the SwiGLU MLP, and the matmul
whose operands the control rounds to fp8."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

f32 = torch.float32

# fp8's largest finite values: operands are scaled by their absolute
# maximum onto these before the cast (per-tensor scaling, as fp8 training
# does), e4m3 forward and e5m2 for the gradients
_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = top / amax
    return (x * scale).to(dtype).to(f32) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, _E5M2_MAX)


class Prec:
    """How the reference computes: float32, or (the control) in fp8: every
    linear layer's two operands, and every activation the configuration's
    bf16 keeps between operations (``act``: the embedding's output, q, k
    and v, each block's residual stream, the logits), rounded to fp8 (e4m3, their gradients e5m2), the sums in float32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.act(a) @ self.act(b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions 0..S-1: the first and second half of
    each head rotated by angle pos * theta^(-i / (hd/2))."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=f32, device=x.device) / half)
    ang = torch.arange(s, dtype=f32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, dims: dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Causal multi-head attention with rotary positions (GQA by repeated
    KV heads). x (B, S, d)."""
    b, s, _ = x.shape
    nh, nkv, hd = dims["num_heads"], dims["num_kv_heads"], dims["head_dim"]
    q = prec.act(prec.mm(x, p["wq"])).view(b, s, nh, hd)
    k = prec.act(prec.mm(x, p["wk"])).view(b, s, nkv, hd)
    v = prec.act(prec.mm(x, p["wv"])).view(b, s, nkv, hd)
    q, k = rope(q, dims["rope_theta"]), rope(k, dims["rope_theta"])
    if nh != nkv:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bnst,btnh->bsnh", torch.softmax(scores, -1), v)
    return prec.mm(out.reshape(b, s, nh * hd), p["wo"])


def swiglu(p: dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"]), p["wo"])


def dense_block(p: dict, dims: dict, x: torch.Tensor, ffn, prec: Prec):
    """Pre-norm residual block: attention, then ``ffn``."""
    eps = dims["norm_eps"]
    x = prec.act(x + attention(p["attn"], dims,
                               rmsnorm(x, p["ln1"]["scale"], eps), prec))
    return prec.act(x + ffn(rmsnorm(x, p["ln2"]["scale"], eps)))


def lm_loss(params: dict, dims: dict, x: torch.Tensor, labels, prec: Prec):
    """Final norm, the output head, and the mean next-token cross-entropy."""
    x = rmsnorm(x, params["final_norm"]["scale"], dims["norm_eps"])
    logits = prec.act(prec.mm(x, params["unembed"]))[:, :-1]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels[:, 1:].reshape(-1).long())


def padded_vocab(dims: dict) -> int:
    """The vocabulary rows the weights hold: a multiple of 256 (the port's
    layout; the labels never name a padded row)."""
    return -(-dims["vocab_size"] // 256) * 256
