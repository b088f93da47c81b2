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

``fsdp=True`` serves params held as fsdp shards over the ranks of
``coll`` (the reference shards them over its data axes for the archs
whose params do not fit replicated): the built functions take the held
ranks' shards (``train_step.shard_params(params, fsdp_layout_of(model,
coll.p), held_ranks(coll, coll.p))``) and gather one layer at a time
from them as the model reads it (``train_step.FsdpParams``), the
previous layer freed first. Over ``StackedCollectives(p)`` the step
serves the whole batch; with one rank a process, the prefill takes the
global batch and each process serves its own B/p rows (the reference's
``P(dp, None)`` token spec) when p divides B, every row otherwise, and
the decode step serves the rows of the state it is given.

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
from repro_torch.train import train_step as ts


def _params_view(model: Model, fsdp: bool, coll):
    """params -> what the model reads: the params themselves, or under
    fsdp the held shards behind a layer-at-a-time gather."""
    if not fsdp:
        if coll is not None:
            raise ValueError("coll holds fsdp's shards: pass fsdp=True")
        return lambda params: params
    if coll is None:
        raise ValueError("fsdp serving needs coll, the context whose ranks "
                         "hold the shards")
    layout = ts.fsdp_layout_of(model, coll.p)
    return lambda shards: ts.FsdpParams(shards, layout, coll)


def serve_rows(coll, batch_size: int) -> slice:
    """The rows of a global batch this process serves: its B/p when one
    rank a process holds the shards and p divides B, else all of them."""
    held = coll is not None and coll.local_ranks < coll.p
    if not held or batch_size % coll.p:
        return slice(None)
    m = batch_size // coll.p
    return slice(coll.rank * m, (coll.rank + 1) * m)


def build_serve_step(model: Model, cache_len: int = 4096, fsdp: bool = False,
                     coll=None):
    """decode_step(params, state, tokens, moe_serve=None) -> (logits,
    state') for states of cache length ``cache_len``; a state whose KV
    caches (..., B, W, nkv, hd) have another width raises (the ssm family
    has no KV cache). Without ``moe_serve`` a MoE model takes the
    training-style ``moe_apply`` at capacity(B), as the reference's
    static engine does. ``fsdp``: ``params`` are the held ranks' shards
    over ``coll`` (see the module); tokens are the rows of ``state``."""
    w = _attn_cache_width(model.cfg, cache_len)
    view = _params_view(model, fsdp, coll)

    def step(params, state, tokens, moe_serve=None):
        if state.kv is not None and state.kv.k.shape[-3] != w:
            raise ValueError(f"decode state of cache width "
                             f"{state.kv.k.shape[-3]}, the step was built "
                             f"for {w}")
        return model.decode_step(view(params), state, tokens,
                                 moe_serve=moe_serve)

    return step


def build_prefill(model: Model, cache_len: int, fsdp: bool = False,
                  coll=None):
    """prefill(params, batch) -> (last-token logits, DecodeState padded to
    ``cache_len``). ``fsdp``: ``params`` are the held ranks' shards over
    ``coll``; with one rank a process the batch is the global one and the
    results are this process's rows (:func:`serve_rows`)."""
    view = _params_view(model, fsdp, coll)

    def pre(params, batch):
        rows = serve_rows(coll, next(iter(batch.values())).shape[0])
        batch = {k: v[rows] for k, v in batch.items()}
        return model.prefill(view(params), batch, cache_len)

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
