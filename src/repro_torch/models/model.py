"""The dense LM: parameter init, forward, loss, and the ``Model`` module.

Parameters are a nested dict in the JAX package's layout and key names
(``repro.models.model``): per-layer leaves are STACKED on a leading
(num_layers,) axis under ``params["blocks"]``, and the forward walks the
layers by indexing that axis (the reference's ``lax.scan``). Keeping the
layout lets weights move between the packages unchanged
(``models/convert.py``) and keeps the sync plan's leaves identical.

Serving: ``prefill`` runs a prompt and returns the last position's logits
and a :class:`DecodeState`; ``decode_step`` takes one token a row. The
state's caches are stacked over the layers, (L, B, W, nkv, hd) as in the
reference, and ``decode_step`` writes them in place (the reference
donates the state): the state it returns holds the same cache tensors.

Only the dense family is ported so far; the others raise, naming ROADMAP
Queue 1 item 12.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import KVCache


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 "
            "item 12)")


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator``, on the card unless ``device`` says otherwise.
    ``device="meta"`` gives shapes only."""
    _dense_only(cfg)
    device = resolve_device(device)
    d, v, n = cfg.d_model, cfg.padded_vocab, cfg.num_layers
    g, dt = generator, cfg.param_dtype
    params: dict = {
        "embed": L._dense_init(g, (v, d), dt, 0.02, device),
        "final_norm": L.rmsnorm_init(d, dt, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L._dense_init(g, (d, v), dt, d ** -0.5, device)
    params["blocks"] = {
        "ln1": L.rmsnorm_init(d, dt, device, lead=(n,)),
        "attn": L.attn_init(g, cfg, device, lead=(n,)),
        "ln2": L.rmsnorm_init(d, dt, device, lead=(n,)),
        "mlp": L.mlp_init(g, cfg, device, lead=(n,)),
    }
    return params


def _unbind_layers(blocks: dict, n: int) -> list[dict]:
    """Stacked (n, ...) leaves -> n per-layer dicts. One ``unbind`` per
    leaf: its backward stacks the layers' grads in one write, where
    indexing layer by layer would build a zero (n, ...) gradient per
    layer and add them up."""
    per_leaf = {k: (_unbind_layers(v, n) if isinstance(v, dict)
                    else v.unbind(0)) for k, v in blocks.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _dense_block(p, cfg: ModelConfig, x, positions, causal=True):
    h = L.attention(p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                    positions, causal=causal)
    x = x + h
    z = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], cfg, z)


def forward(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {'tokens': (B,S) int}. Returns f32 logits (B, S, V)."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    for layer in _unbind_layers(params["blocks"], cfg.num_layers):
        x = _dense_block(layer, cfg, x, positions, causal=cfg.is_decoder)
    return _logits(params, cfg, x)


def _logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ unembed.to(cfg.dtype)).to(torch.float32)


def loss_fn(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    logits = forward(params, cfg, batch)
    labels = batch["labels"].long()
    if cfg.is_decoder:
        logits, labels = logits[:, :-1], labels[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.mean(ll)


# ==========================================================================
# Serving: prefill + decode
# ==========================================================================

class DecodeState(NamedTuple):
    pos: torch.Tensor    # int32: () the next position to write, or (B,)
    kv: KVCache          # stacked over the layers: (L, B, W, nkv, hd) each


def _attn_cache_width(cfg: ModelConfig, cache_len: int) -> int:
    return (min(cache_len, cfg.sliding_window) if cfg.sliding_window
            else cache_len)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int):
    """Run the prompt; returns (last-token logits (B, V) f32, DecodeState)."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for lp in _unbind_layers(params["blocks"], cfg.num_layers):
        hn = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        a, cache = L.attention_prefill(lp["attn"], cfg, hn, positions,
                                       cache_len)
        x = x + a
        x = x + L.mlp(lp["mlp"], cfg, L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
        ks.append(cache.k)
        vs.append(cache.v)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    pos = torch.full((), s, dtype=torch.int32, device=x.device)
    return logits, DecodeState(pos, KVCache(torch.stack(ks), torch.stack(vs)))


def init_decode_state(cfg: ModelConfig, batch_size: int, cache_len: int,
                      prefix_len: int = 0, device="cuda") -> DecodeState:
    """An empty decode state (zero caches), on the card unless ``device``
    says otherwise."""
    _dense_only(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch_size, _attn_cache_width(cfg, cache_len),
             cfg.num_kv_heads, cfg.head_dim)
    kv = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                 torch.zeros(shape, dtype=cfg.dtype, device=device))
    return DecodeState(torch.full((), prefix_len, dtype=torch.int32,
                                  device=device), kv)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor):
    """One autoregressive step. tokens: (B, 1) -> (logits (B, V), state').

    ``state.pos`` is a 0-d position (batch-synchronous decode) or a (B,)
    per-slot position vector (continuous batching; see
    ``layers.attention_decode``). The caches of ``state`` are written in
    place and returned in ``state'``, whose ``pos`` is ``state.pos + 1``."""
    _dense_only(cfg)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    pos = state.pos
    layers = _unbind_layers(params["blocks"], cfg.num_layers)
    for lp, ck, cv in zip(layers, state.kv.k, state.kv.v):
        hn = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        a, _ = L.attention_decode(lp["attn"], cfg, hn, KVCache(ck, cv), pos)
        x = x + a
        x = x + L.mlp(lp["mlp"], cfg, L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return _logits(params, cfg, x)[:, 0], DecodeState(pos + 1, state.kv)


class Model(nn.Module):
    """The config plus the pure functions over a params dict. It holds no
    parameters itself: the train step keeps one params dict and computes
    each replica's gradients against it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda"):
        return init_params(self.cfg, generator, device)

    def forward(self, params, batch):
        return forward(params, self.cfg, batch)

    def loss(self, params, batch):
        return loss_fn(params, self.cfg, batch)

    def prefill(self, params, batch, cache_len: int):
        return prefill(params, self.cfg, batch, cache_len)

    def decode_step(self, params, state, tokens):
        return decode_step(params, self.cfg, state, tokens)

    def init_decode_state(self, batch_size: int, cache_len: int,
                          prefix_len: int = 0, device="cuda"):
        return init_decode_state(self.cfg, batch_size, cache_len,
                                 prefix_len, device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
