"""Deterministic synthetic data, keyed by (seed, step).

A copy of ``repro.data.pipeline`` (the port never imports the JAX
package), so both packages train on the same batches: the token stream,
and the stub frontends' inputs drawn after it from the same generator,
frames for the audio encoder and image embeddings for the vlm."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 1234
    kind: str = "lm"          # lm | audio | vlm
    frontend_dim: int = 0     # audio frame-embedding dim
    num_image_tokens: int = 0
    vision_dim: int = 0


def synthetic_batch(cfg: DataConfig, step: int) -> dict:
    """Batch for global step `step`: a random walk over the vocab with
    local coherence, so the LM loss actually decreases (+ 'frames' (B, S,
    frontend_dim) for audio, 'image_embeds' (B, T_img, vision_dim) for
    vlm, standard normal f32)."""
    rng = np.random.default_rng(cfg.seed + step * 1_000_003)
    b, s = cfg.global_batch, cfg.seq_len
    start = rng.integers(0, cfg.vocab_size, size=(b, 1))
    steps = rng.integers(-3, 4, size=(b, s - 1))
    toks = np.concatenate([start, start + np.cumsum(steps, axis=1)], axis=1)
    toks = np.mod(toks, cfg.vocab_size).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.kind == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    if cfg.kind == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


def make_batch_iterator(cfg: DataConfig, start_step: int = 0
                        ) -> Iterator[dict]:
    """The batches of steps ``start_step``, ``start_step + 1``, ... (a
    resume starts at its checkpoint's step)."""
    step = start_step
    while True:
        yield synthetic_batch(cfg, step)
        step += 1
