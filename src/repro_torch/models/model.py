"""The dense LM: parameter init, forward, loss, and the ``Model`` module.

Parameters are a nested dict in the JAX package's layout and key names
(``repro.models.model``): per-layer leaves are STACKED on a leading
(num_layers,) axis under ``params["blocks"]``, and the forward walks the
layers by indexing that axis (the reference's ``lax.scan``). Keeping the
layout lets weights move between the packages unchanged
(``models/convert.py``) and keeps the sync plan's leaves identical.

Only the dense family is ported so far.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator``, on the card unless ``device`` says otherwise.
    ``device="meta"`` gives shapes only."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
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
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    for layer in _unbind_layers(params["blocks"], cfg.num_layers):
        x = _dense_block(layer, cfg, x, positions, causal=cfg.is_decoder)
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


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
