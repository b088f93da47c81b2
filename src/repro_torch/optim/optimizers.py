"""Optimizers: AdamW and SGD+momentum (the paper's Alg. 2 setting) as
functions over dict trees of tensors, in the JAX package's arithmetic
order (``repro.optim.optimizers``). Scalars that the reference computes
in f32 (bias corrections, clip factor) are f32 tensors here too."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"            # adamw | sgdm
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9          # sgdm
    state_dtype: Any = torch.float32
    grad_clip: float = 1.0


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    def z(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    if cfg.kind == "adamw":
        return {"mu": tree_map(z, params), "nu": tree_map(z, params),
                "count": count}
    if cfg.kind == "sgdm":
        return {"mu": tree_map(z, params), "count": count}
    raise ValueError(cfg.kind)


def _global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = _global_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * factor).to(g.dtype),
                    grads), norm


def _bias_corrections(count: torch.Tensor, cfg: OptimizerConfig):
    # torch.full, not torch.tensor: a scalar copied to the card would make
    # the host wait for the stream (the pipelined step never does)
    cf = count.to(torch.float32)
    b1 = torch.full((), cfg.beta1, dtype=torch.float32, device=count.device)
    b2 = torch.full((), cfg.beta2, dtype=torch.float32, device=count.device)
    return 1.0 - b1 ** cf, 1.0 - b2 ** cf


def adamw(params, grads, state, lr, cfg: OptimizerConfig):
    count = state["count"] + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c1, c2 = _bias_corrections(count, cfg)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m2 = b1 * m.to(torch.float32) + (1 - b1) * gf
        v2 = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        step = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        p2 = p.to(torch.float32) - lr * step
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    return (tree_map(lambda o: o[0], out),
            {"mu": tree_map(lambda o: o[1], out),
             "nu": tree_map(lambda o: o[2], out), "count": count})


def sgd_momentum(params, grads, state, lr, cfg: OptimizerConfig):
    count = state["count"] + 1

    def upd(p, g, m):
        m2 = cfg.momentum * m.to(torch.float32) + g.to(torch.float32)
        p2 = p.to(torch.float32) - lr * m2
        return p2.to(p.dtype), m2.to(m.dtype)

    out = tree_map(upd, params, grads, state["mu"])
    return (tree_map(lambda o: o[0], out),
            {"mu": tree_map(lambda o: o[1], out), "count": count})


def opt_update(params, grads, state, lr, cfg: OptimizerConfig):
    # The train step has already clipped; the reference clips again here
    # (a no-op up to rounding once the norm is <= grad_clip) and so does
    # the port, to keep its arithmetic.
    if cfg.grad_clip:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    if cfg.kind == "adamw":
        return adamw(params, grads, state, lr, cfg)
    if cfg.kind == "sgdm":
        return sgd_momentum(params, grads, state, lr, cfg)
    raise ValueError(cfg.kind)
