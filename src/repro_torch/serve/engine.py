"""Serving: batched prefill + synchronous batched greedy decode (the JAX
package's ``repro.serve.engine``).

``build_serve_step`` returns the one-token decode function and
``build_prefill`` the prompt's. :class:`ServeEngine` wraps them with a
minimal batching loop (fixed slots, batch-synchronous); it is the
per-request exactness reference for the continuous-batching engine in
``serve/sparse_decode.py`` (DESIGN.md §8).

The port runs on one device, so the reference's mesh, its cache
shardings (``decode_state_specs``) and the sharding arguments of the
built functions (the batch size among them: a step serves any batch)
have no counterpart here. The decode state's caches are
written in place (``models/model.decode_step``), where the reference
donates them to its jitted step.

The static engine reads the device once a ``generate``: each step's
greedy tokens stay on the device as the next step's input, and the
tokens come to the host together at the end (the reference copies each
step's tokens to the host). ``torch.argmax`` returns the first maximal
index, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model, _attn_cache_width
from repro_torch.obs import resolve as _resolve_obs


def build_serve_step(model: Model, cache_len: int = 4096):
    """decode_step(params, state, tokens, moe_serve=None) -> (logits,
    state') for states of cache length ``cache_len``; a state whose KV
    caches (..., B, W, nkv, hd) have another width raises (the ssm family
    has no KV cache). Without ``moe_serve`` a MoE model takes the
    training-style ``moe_apply`` at capacity(B), as the reference's
    static engine does."""
    w = _attn_cache_width(model.cfg, cache_len)

    def step(params, state, tokens, moe_serve=None):
        if state.kv is not None and state.kv.k.shape[-3] != w:
            raise ValueError(f"decode state of cache width "
                             f"{state.kv.k.shape[-3]}, the step was built "
                             f"for {w}")
        return model.decode_step(params, state, tokens, moe_serve=moe_serve)

    return step


def build_prefill(model: Model, cache_len: int):
    """prefill(params, batch) -> (last-token logits, DecodeState padded to
    ``cache_len``)."""

    def pre(params, batch):
        return model.prefill(params, batch, cache_len)

    return pre


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 greedy tokens (the first maximal index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ServeEngine:
    """Minimal batched greedy-decoding engine over fixed slots, on the
    card unless ``device`` says otherwise."""

    def __init__(self, model: Model, params, cache_len: int = 256,
                 obs=None, device="cuda"):
        self.model = model
        self.params = params
        self.cache_len = cache_len
        self.device = resolve_device(device)
        self.obs = _resolve_obs(obs)
        self.prefill_fn = build_prefill(model, cache_len)
        self.decode_fn = build_serve_step(model, cache_len)

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16,
                 image_embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (B, S) int32 -> (B, max_new_tokens) greedy tokens.
        ``image_embeds`` (B, T_img, vision_dim): the vlm's stub vision
        tokens."""
        rec = getattr(self.obs, "recorder", None)
        try:
            return self._generate(np.asarray(prompts, np.int32),
                                  max_new_tokens, image_embeds)
        except Exception as e:
            if rec is not None:
                rec._safe_dump(f"exception:{type(e).__name__}")
            raise

    def _generate(self, prompts: np.ndarray, max_new_tokens: int,
                  image_embeds) -> np.ndarray:
        batch = {"tokens": torch.from_numpy(prompts).to(self.device)}
        if image_embeds is not None:
            batch["image_embeds"] = torch.as_tensor(image_embeds).to(
                self.device)
        with self.obs.span("serve/prefill", batch=int(prompts.shape[0]),
                           prompt_len=int(prompts.shape[1])):
            logits, state = self.prefill_fn(self.params, batch)
        cur = greedy(logits)[:, None]
        toks = [cur]
        with self.obs.span("serve/decode", tokens=max_new_tokens):
            # the last token needs no step after it
            for _ in range(max_new_tokens - 1):
                logits, state = self.decode_fn(self.params, state, cur)
                cur = greedy(logits)[:, None]
                toks.append(cur)
        return torch.cat(toks, dim=1).cpu().numpy()
