"""Model assembly: parameter init, forward, loss, prefill and decode for
every family, and the ``Model`` module.

Parameters are a nested dict in the JAX package's layout and key names
(``repro.models.model``): per-layer leaves are STACKED on leading axes
under ``params["blocks"]``, and the forward walks the layers by unbinding
those axes (the reference's ``lax.scan``). Keeping the layout lets weights
move between the packages unchanged (``models/convert.py``) and keeps the
sync plan's leaves identical. Mixed-layout families stack superblocks:

  hybrid (zamba2): ``blocks`` is (nsb, attn_every, ...) mamba layers; one
         unstacked ``shared_block`` (attention + MLP) runs after each
         superblock, so its gradient sums over the nsb call sites; each
         call site keeps its own KV cache.
  vlm    (llama-3.2-vision): ``blocks = {"selfs": (nsb, every-1, ...),
         "cross": (nsb, ...)}``, a gated cross-attention layer closing each
         superblock.
  encoder (hubert): stub frame embeddings through ``frontend_proj`` plus
         ``pos_embed``, non-causal attention, no decode.

``cfg.remat`` (on by default, as in the reference) recomputes each block
in the backward: ``_Remat`` is an ``autograd.Function`` that keeps only
the block's inputs and recomputes the block with ``torch.func.vjp``. It
composes with the ``vmap(grad_and_value)`` of the training step, which
``torch.utils.checkpoint`` does not.

Serving: ``prefill`` runs a prompt and returns the last position's logits
and a :class:`DecodeState`; ``decode_step`` takes one token a row. Both
read the stacked layers through ``_layers``, so a params source that
gathers each layer when it is read (fsdp serving) serves the same way. The
state's caches are stacked as in the reference: KV (L, B, W, nkv, hd)
((nsb, ...) for hybrid, (nsb, every-1, B, ...) for vlm, whose static image
K/V ``cross_kv`` is (nsb, B, T_img, nkv, hd)); the SSM conv window
(L, B, W-1, conv_dim) and state (L, B, H, P, N). ``decode_step`` writes
them in place (the reference donates the state): the state it returns
holds the same tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import KVCache
from repro_torch.utils.tree import tree_flatten, tree_unflatten

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encoder")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: {FAMILIES}")


# ==========================================================================
# Parameter initialization
# ==========================================================================

def _dense_block_init(g, cfg: ModelConfig, device, lead) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    p = {"ln1": L.rmsnorm_init(d, dt, device, lead),
         "attn": L.attn_init(g, cfg, device, lead=lead),
         "ln2": L.rmsnorm_init(d, dt, device, lead)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(g, cfg, device, lead=lead)
    else:
        p["mlp"] = L.mlp_init(g, cfg, device, lead=lead)
    return p


def _mamba_block_init(g, cfg: ModelConfig, device, lead) -> dict:
    return {"ln": L.rmsnorm_init(cfg.d_model, cfg.param_dtype, device, lead),
            "mixer": ssm_mod.mamba_init(g, cfg, device, lead)}


def _cross_block_init(g, cfg: ModelConfig, device, lead) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    return {"ln1": L.rmsnorm_init(d, dt, device, lead),
            "xattn": L.cross_attn_init(g, cfg, device, lead),
            "ln2": L.rmsnorm_init(d, dt, device, lead),
            "mlp": L.mlp_init(g, cfg, device, lead=lead),
            "mlp_gate": torch.zeros(lead, dtype=dt, device=device)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator``, on the card unless ``device`` says otherwise.
    ``device="meta"`` gives shapes only."""
    _check_family(cfg)
    device = resolve_device(device)
    d, v, n = cfg.d_model, cfg.padded_vocab, cfg.num_layers
    g, dt = generator, cfg.param_dtype
    params: dict = {
        "embed": L._dense_init(g, (v, d), dt, 0.02, device),
        "final_norm": L.rmsnorm_init(d, dt, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L._dense_init(g, (d, v), dt, d ** -0.5, device)
    fam = cfg.family
    if fam in ("dense", "moe", "encoder"):
        params["blocks"] = _dense_block_init(g, cfg, device, (n,))
    if fam == "encoder":
        params["frontend_proj"] = L._dense_init(
            g, (cfg.frontend_dim or d, d), dt, None, device)
        params["pos_embed"] = L._dense_init(g, (cfg.max_seq_len, d), dt,
                                            0.02, device)
    elif fam == "ssm":
        params["blocks"] = _mamba_block_init(g, cfg, device, (n,))
    elif fam == "hybrid":
        params["blocks"] = _mamba_block_init(
            g, cfg, device, (n // cfg.attn_every, cfg.attn_every))
        params["shared_block"] = _dense_block_init(g, cfg, device, ())
    elif fam == "vlm":
        every = cfg.cross_attn_every
        nsb = n // every
        params["blocks"] = {
            "selfs": _dense_block_init(g, cfg, device, (nsb, every - 1)),
            "cross": _cross_block_init(g, cfg, device, (nsb,))}
        params["vision_proj"] = L._dense_init(g, (cfg.vision_dim, d), dt,
                                              None, device)
    return params


def _unbind_layers(blocks: dict, n: int) -> list[dict]:
    """Stacked (n, ...) leaves -> n per-layer dicts. One ``unbind`` per
    leaf: its backward stacks the layers' grads in one write, where
    indexing layer by layer would build a zero (n, ...) gradient per
    layer and add them up. A two-axis stack unbinds its first axis; unbind
    each result again for the second."""
    per_leaf = {k: (_unbind_layers(v, n) if isinstance(v, dict)
                    else v.unbind(0)) for k, v in blocks.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _layers(blocks, n: int) -> list:
    """The n layers of stacked ``blocks`` for serving: unbound, or, from
    a source that gathers each layer when it is read (fsdp serving's
    ``train_step.FsdpParams``), that source's own layer views."""
    layers = getattr(blocks, "layers", None)
    return layers(n) if layers is not None else _unbind_layers(blocks, n)


# ==========================================================================
# Block application (one layer, unstacked params)
# ==========================================================================

def _ffn(p, cfg: ModelConfig, z, moe_serve=None):
    """The block's feed-forward on (B, S, d): the MLP, or the MoE layer
    over the B*S flattened tokens (the serve-time dispatch when
    ``moe_serve``, a ``moe.ServeDispatch``, is given)."""
    if cfg.family != "moe":
        return L.mlp(p["mlp"], cfg, z)
    b, s, d = z.shape
    z2 = z.reshape(b * s, d)
    if moe_serve is not None:
        f = moe_mod.moe_apply_serve(p["moe"], cfg, z2, moe_serve)
    else:
        f = moe_mod.moe_apply(p["moe"], cfg, z2)
    return f.reshape(b, s, d)


def _dense_block(p, cfg: ModelConfig, x, positions, causal=True):
    h = L.attention(p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                    positions, causal=causal)
    x = x + h
    return x + _ffn(p, cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _mamba_block(p, cfg: ModelConfig, x):
    h, _ = ssm_mod.mamba_apply(p["mixer"], cfg,
                               L.rmsnorm(p["ln"], x, cfg.norm_eps))
    return x + h


def _cross_block(p, cfg: ModelConfig, x, k, v):
    """The gated cross-attention layer, against the image tokens' keys and
    values (``layers.cross_kv``)."""
    x = x + L.cross_attend(p["xattn"], cfg,
                           L.rmsnorm(p["ln1"], x, cfg.norm_eps), k, v)
    g = torch.tanh(p["mlp_gate"].to(torch.float32)).to(x.dtype)
    return x + g * L.mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))


_KV_SIDE = ("wk", "wv", "k_norm")


def _query_side(p: dict) -> dict:
    """A cross block's params without its image K/V projection."""
    return {**p, "xattn": {k: v for k, v in p["xattn"].items()
                           if k not in _KV_SIDE}}


class _Remat(torch.autograd.Function):
    """fn(*tensors) -> one tensor, recomputed in the backward: only the
    inputs are saved, and the backward is ``torch.func.vjp`` of ``fn`` on
    them. ``setup_context`` and the generated vmap rule let it run under
    ``torch.func.vmap`` and ``grad`` (the training step's rank grads)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            _, vjp_fn = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
            grads = vjp_fn(grad)
        # detached: under torch.func.grad the backward runs with
        # create_graph, and grads that kept the recompute's graph would
        # hold every layer's activations until the whole backward ends
        return (None,) + tuple(g.detach() for g in grads)


def _block(cfg: ModelConfig, fn, p: dict, x, *extra):
    """fn(p, x, *extra) -> x', recomputed in the backward when
    ``cfg.remat`` (the reference's ``_maybe_remat``) and a gradient is
    being taken."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(p, x, *extra)
    leaves, paths = tree_flatten(p)
    n = len(leaves)

    def flat(x, *ts):
        return fn(tree_unflatten(paths, list(ts[:n])), x, *ts[n:])

    return _Remat.apply(flat, x, *leaves, *extra)


# ==========================================================================
# Full forward (training / encoder inference)
# ==========================================================================

def _embed(params, cfg: ModelConfig, batch: dict):
    if cfg.family == "encoder":
        x = batch["frames"].to(cfg.dtype) @ params["frontend_proj"]
        return x + params["pos_embed"][:x.shape[1]][None]
    return params["embed"][batch["tokens"].long()].to(cfg.dtype)


def _vision(params, cfg: ModelConfig, batch: dict):
    return batch["image_embeds"].to(cfg.dtype) @ params["vision_proj"]


def forward(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {'tokens': (B, S) int} (+ 'image_embeds' (B, T_img,
    vision_dim) for vlm; 'frames' (B, S, frontend_dim) instead of tokens
    for the encoder). Returns f32 logits (B, S, V)."""
    _check_family(cfg)
    fam = cfg.family
    x = _embed(params, cfg, batch)

    # the blocks make their own tensors: a remat block's vmap rule cannot
    # see tensors captured from outside it
    def dense(p, h, causal=True):
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        return _dense_block(p, cfg, h, positions, causal=causal)

    def mamba(p, h):
        return _mamba_block(p, cfg, h)

    def cross(p, h, k, v):
        return _cross_block(p, cfg, h, k, v)

    if fam in ("dense", "moe", "encoder"):
        causal = cfg.is_decoder
        for lp in _unbind_layers(params["blocks"], cfg.num_layers):
            x = _block(cfg, lambda p, h: dense(p, h, causal), lp, x)
    elif fam == "ssm":
        for lp in _unbind_layers(params["blocks"], cfg.num_layers):
            x = _block(cfg, mamba, lp, x)
    elif fam == "hybrid":
        every = cfg.attn_every
        for sbp in _unbind_layers(params["blocks"], cfg.num_layers // every):
            for lp in _unbind_layers(sbp, every):
                x = _block(cfg, mamba, lp, x)
            x = _block(cfg, dense, params["shared_block"], x)
    else:  # vlm
        every = cfg.cross_attn_every
        kv_feats = _vision(params, cfg, batch)
        blocks = params["blocks"]
        nsb = cfg.num_layers // every
        for sbp, cp in zip(_unbind_layers(blocks["selfs"], nsb),
                           _unbind_layers(blocks["cross"], nsb)):
            for lp in _unbind_layers(sbp, every - 1):
                x = _block(cfg, dense, lp, x)
            # the image K/V outside the recomputed block: kv_feats then
            # sums its gradient in the same order with remat on or off
            k, v = L.cross_kv(cp["xattn"], cfg, kv_feats)
            x = _block(cfg, cross, _query_side(cp), x, k, v)
    return _logits(params, cfg, x)


def _logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ unembed.to(cfg.dtype)).to(torch.float32)


def loss_fn(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token (decoder) or per-frame (encoder) cross-entropy."""
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
    pos: torch.Tensor           # int32: () the next position to write, or (B,)
    kv: Optional[KVCache] = None        # stacked attention caches
    cross_kv: Optional[KVCache] = None  # vlm: (nsb, B, T_img, nkv, hd) each
    conv: Optional[torch.Tensor] = None  # ssm/hybrid: (L, B, W-1, conv_dim)
    ssm: Optional[torch.Tensor] = None   # ssm/hybrid: (L, B, H, P, N) f32


def _attn_cache_width(cfg: ModelConfig, cache_len: int) -> int:
    return (min(cache_len, cfg.sliding_window) if cfg.sliding_window
            else cache_len)


def _no_decode(cfg: ModelConfig) -> None:
    if not cfg.is_decoder:
        raise ValueError("encoder-only archs have no decode step")


def _stack_kv(caches: list) -> KVCache:
    return KVCache(torch.stack([c.k for c in caches]),
                   torch.stack([c.v for c in caches]))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int):
    """Run the prompt; returns (last-token logits (B, V) f32, DecodeState).
    The ssm and hybrid families need a prompt that is a multiple of
    ``ssm_chunk`` long (the SSD scan's precondition, as in the
    reference)."""
    _check_family(cfg)
    _no_decode(cfg)
    fam = cfg.family
    x = _embed(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    eps = cfg.norm_eps
    caches, convs, states = [], [], []
    cross_kv = None

    def attend(lp, h):
        a, cache = L.attention_prefill(lp["attn"], cfg,
                                       L.rmsnorm(lp["ln1"], h, eps),
                                       positions, cache_len)
        caches.append(cache)
        h = h + a
        return h + _ffn(lp, cfg, L.rmsnorm(lp["ln2"], h, eps))

    def mamba(lp, h):
        out, state, conv_in = ssm_mod.mamba_forward(
            lp["mixer"], cfg, L.rmsnorm(lp["ln"], h, eps))
        states.append(state)
        convs.append(conv_in[:, -(cfg.conv_width - 1):])
        return h + out

    if fam in ("dense", "moe"):
        for lp in _layers(params["blocks"], cfg.num_layers):
            x = attend(lp, x)
    elif fam == "ssm":
        for lp in _layers(params["blocks"], cfg.num_layers):
            x = mamba(lp, x)
    elif fam == "hybrid":
        every = cfg.attn_every
        for sbp in _layers(params["blocks"], cfg.num_layers // every):
            for lp in _layers(sbp, every):
                x = mamba(lp, x)
            x = attend(params["shared_block"], x)
    else:  # vlm
        every = cfg.cross_attn_every
        nsb = cfg.num_layers // every
        kv_feats = _vision(params, cfg, batch)
        blocks = params["blocks"]
        img = []
        for sbp, cp in zip(_layers(blocks["selfs"], nsb),
                           _layers(blocks["cross"], nsb)):
            for lp in _layers(sbp, every - 1):
                x = attend(lp, x)
            img.append(KVCache(*L.cross_kv(cp["xattn"], cfg, kv_feats)))
            x = _cross_block(cp, cfg, x, *img[-1])
        caches = [_stack_kv(caches[i:i + every - 1])
                  for i in range(0, len(caches), every - 1)]
        cross_kv = _stack_kv(img)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    pos = torch.full((), s, dtype=torch.int32, device=x.device)
    return logits, DecodeState(
        pos, kv=_stack_kv(caches) if caches else None, cross_kv=cross_kv,
        conv=torch.stack(convs) if convs else None,
        ssm=torch.stack(states) if states else None)


def init_decode_state(cfg: ModelConfig, batch_size: int, cache_len: int,
                      prefix_len: int = 0, device="cuda") -> DecodeState:
    """An empty decode state (zero caches and states), on the card unless
    ``device`` says otherwise."""
    _check_family(cfg)
    device = resolve_device(device)
    b, dt, fam = batch_size, cfg.dtype, cfg.family
    attn = (b, _attn_cache_width(cfg, cache_len), cfg.num_kv_heads,
            cfg.head_dim)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(lead):
        return KVCache(zeros(lead + attn), zeros(lead + attn))

    st = DecodeState(torch.full((), prefix_len, dtype=torch.int32,
                                device=device))
    if fam in ("dense", "moe"):
        st = st._replace(kv=kv((cfg.num_layers,)))
    elif fam == "hybrid":
        st = st._replace(kv=kv((cfg.num_layers // cfg.attn_every,)))
    elif fam == "vlm":
        every = cfg.cross_attn_every
        nsb = cfg.num_layers // every
        img = (nsb, b, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
        st = st._replace(kv=kv((nsb, every - 1)),
                         cross_kv=KVCache(zeros(img), zeros(img)))
    if fam in ("ssm", "hybrid"):
        n = cfg.num_layers
        st = st._replace(
            conv=zeros((n, b, cfg.conv_width - 1,
                        cfg.d_inner + 2 * cfg.ssm_state)),
            ssm=zeros((n, b, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state), torch.float32))
    return st


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor, moe_serve=None):
    """One autoregressive step. tokens: (B, 1) -> (logits (B, V), state').

    ``state.pos`` is a 0-d position (batch-synchronous decode) or a (B,)
    per-slot position vector (continuous batching; see
    ``layers.attention_decode``). The caches and SSM states of ``state``
    are written in place and returned in ``state'``, whose ``pos`` is
    ``state.pos + 1``. ``moe_serve``: an optional ``moe.ServeDispatch``;
    when given, the MoE layers take the serve-time dispatch (active-slot
    masking and the planned combine exchange) instead of the
    training-style ``moe_apply`` at capacity(B)."""
    _check_family(cfg)
    _no_decode(cfg)
    fam = cfg.family
    x = params["embed"][tokens.long()].to(cfg.dtype)
    pos = state.pos
    eps = cfg.norm_eps

    def attend(lp, h, ck, cv):
        a, _ = L.attention_decode(lp["attn"], cfg,
                                  L.rmsnorm(lp["ln1"], h, eps),
                                  KVCache(ck, cv), pos)
        h = h + a
        return h + _ffn(lp, cfg, L.rmsnorm(lp["ln2"], h, eps), moe_serve)

    def mamba(lp, h, i):
        out, _, _ = ssm_mod.mamba_decode(lp["mixer"], cfg,
                                         L.rmsnorm(lp["ln"], h, eps),
                                         state.conv[i], state.ssm[i])
        return h + out

    if fam in ("dense", "moe"):
        layers = _layers(params["blocks"], cfg.num_layers)
        for lp, ck, cv in zip(layers, state.kv.k, state.kv.v):
            x = attend(lp, x, ck, cv)
    elif fam == "ssm":
        for i, lp in enumerate(_layers(params["blocks"],
                                              cfg.num_layers)):
            x = mamba(lp, x, i)
    elif fam == "hybrid":
        every = cfg.attn_every
        nsb = cfg.num_layers // every
        for sb, sbp in enumerate(_layers(params["blocks"], nsb)):
            for j, lp in enumerate(_layers(sbp, every)):
                x = mamba(lp, x, sb * every + j)
            x = attend(params["shared_block"], x, state.kv.k[sb],
                       state.kv.v[sb])
    else:  # vlm
        every = cfg.cross_attn_every
        nsb = cfg.num_layers // every
        blocks = params["blocks"]
        for sb, (sbp, cp) in enumerate(zip(
                _layers(blocks["selfs"], nsb),
                _layers(blocks["cross"], nsb))):
            for j, lp in enumerate(_layers(sbp, every - 1)):
                x = attend(lp, x, state.kv.k[sb, j], state.kv.v[sb, j])
            x = _cross_block(cp, cfg, x, state.cross_kv.k[sb],
                             state.cross_kv.v[sb])
    return _logits(params, cfg, x)[:, 0], state._replace(pos=pos + 1)


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

    def decode_step(self, params, state, tokens, moe_serve=None):
        return decode_step(params, self.cfg, state, tokens,
                           moe_serve=moe_serve)

    def init_decode_state(self, batch_size: int, cache_len: int,
                          prefix_len: int = 0, device="cuda"):
        return init_decode_state(self.cfg, batch_size, cache_len,
                                 prefix_len, device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
