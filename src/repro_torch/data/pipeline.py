"""Deterministic synthetic data, keyed by (seed, step).

A copy of the language-model stream of ``repro.data.pipeline`` (the port
never imports the JAX package), so both packages train on the same
tokens."""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 1234


def synthetic_batch(cfg: DataConfig, step: int) -> dict:
    """Batch for global step `step`: a random walk over the vocab with
    local coherence, so the LM loss actually decreases."""
    rng = np.random.default_rng(cfg.seed + step * 1_000_003)
    b, s = cfg.global_batch, cfg.seq_len
    start = rng.integers(0, cfg.vocab_size, size=(b, 1))
    steps = rng.integers(-3, 4, size=(b, s - 1))
    toks = np.concatenate([start, start + np.cumsum(steps, axis=1)], axis=1)
    toks = np.mod(toks, cfg.vocab_size).astype(np.int32)
    return {"tokens": toks, "labels": toks}
