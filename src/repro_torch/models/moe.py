"""Mixture-of-Experts layer (dbrx 16e/top-4, moonshot 64e/top-6), the JAX
package's ``repro.models.moe``.

Sort-based dispatch (Megablocks-style, no (T, E, C) one-hot): the
token -> expert assignments are sorted by expert id (stable), packed into
(E, C) capacity slots by their position in their expert's segment, run
through one batched (E, C, d) x (E, d, ff) product, and combined back
with the router weights. Assignments past an expert's capacity are
dropped (standard).

What differs from the reference, and why:

* **The combine is a gather in a fixed order.** The reference combines
  with a scatter-add (``.at[slot_token].add``), which XLA on the CPU
  applies one update at a time in slot order, so each token receives its
  k expert rows in ascending slot (= expert) order. On CUDA a scatter-add
  is atomic and its order changes from run to run. The port inverts the
  slot map into a (T, k) table of each token's slot ids in ascending
  order (a dropped assignment points at a zero sentinel row) and sums the
  k gathered rows in that order: deterministic, and the reference's
  order. ``moe_apply_serve``'s per-shard partials are summed the same
  way.
* **No in-place writes into tensors the layer creates**, so the layer
  runs under ``torch.func.vmap`` over the ranks of the training step: the
  reference's ``mode="drop"`` scatters become out-of-place ``scatter``s
  onto buffers with one extra sentinel entry, which is sliced off.
  ``seg_start`` (the reference's ``searchsorted`` of the sorted ids) is
  the count of ids below each expert, a comparison and a sum.
* ``_constrain`` (sharding constraints) is a no-op on one device and is
  not ported.
* **The dense step's ranks share a microbatch's capacity.** The
  reference's dense (and fsdp) step is one global function: a layer
  routes the whole global microbatch, its ranks' rows in rank order, at
  ``capacity(cfg, p * t)``. The port's dense step runs per rank; under
  :func:`shared_capacity` a rank's layer gathers every rank's per-expert
  counts (one ``all_gather`` of E integers), offsets its positions in
  each expert's segment by the lower ranks' counts and keeps those below
  the global capacity: the reference's keep set. A rank packs its kept
  assignments into ``min(capacity(cfg, p * t), t)`` slots an expert (a
  token routes to an expert at most once), so at p > 1 its expert
  product is wider than the SparCML step's, whose ranks route alone in
  both packages.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, mlp, mlp_init


def moe_init(generator, cfg: ModelConfig, device, lead=()) -> dict:
    """The reference's shapes and scales: a (d, E) f32 router at 0.02;
    (E, d, ff) ``wi`` and ``wg`` at 1/sqrt(E) (the reference's fan-in is
    the first dim of the leaf); (E, ff, d) ``wo`` at
    1/sqrt(ff * 2 * num_layers); the optional shared expert an MLP of
    width ``moe_shared_ff``. ``lead``: leading stack axes (the layers)."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    lead = tuple(lead)
    dt = cfg.param_dtype
    p = {
        "router": _dense_init(generator, lead + (d, e), torch.float32, 0.02,
                              device),
        "wi": _dense_init(generator, lead + (e, d, ff), dt, None, device,
                          fan_in=e),
        "wg": _dense_init(generator, lead + (e, d, ff), dt, None, device,
                          fan_in=e),
        "wo": _dense_init(generator, lead + (e, ff, d), dt,
                          1.0 / math.sqrt(ff * 2 * cfg.num_layers), device),
    }
    if cfg.moe_shared_ff:
        p["shared"] = mlp_init(generator, cfg, device, lead,
                               d_ff=cfg.moe_shared_ff)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.experts_per_token
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # align to 8


class _Dispatch(NamedTuple):
    slot_token: torch.Tensor   # (E*C,) token of each slot, T = empty
    slot_w: torch.Tensor       # (E*C,) router weight of each slot, 0 = empty
    token_slots: torch.Tensor  # (T, k) each token's slots, ascending; E*C =
                               # a dropped assignment (the zero sentinel row)


def _route(p, x: torch.Tensor, k: int):
    """Router softmax (f32) and its top-k: (weights (T, k) renormalized in
    x's dtype, expert ids (T, k))."""
    gates = torch.softmax((x @ p["router"].to(x.dtype)).to(torch.float32),
                          dim=-1)
    w, eidx = torch.topk(gates, k, dim=-1)
    w = (w / (w.sum(-1, keepdim=True) + 1e-9)).to(x.dtype)
    return w, eidx


def _dispatch(flat_e: torch.Tensor, w: torch.Tensor, t: int, k: int, e: int,
              c: int, limit: Optional[torch.Tensor] = None) -> _Dispatch:
    """The slot maps of one dispatch. ``flat_e``: (T*k,) expert ids in
    token-major order, ``e`` marking an assignment routed nowhere (it
    sorts after every real expert, so it shifts no segment start).
    ``limit``: (E,) assignments kept an expert (at most ``c``, the slots
    an expert), ``c`` for every expert if None."""
    dev = flat_e.device
    n = t * k
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(e, device=dev)
    # the reference's searchsorted(sorted_e, arange(e)): ids below each
    seg_start = (flat_e[None, :] < experts[:, None]).sum(-1)
    seg = torch.clamp_max(sorted_e, e - 1)
    pos_in_seg = torch.arange(n, device=dev) - seg_start[seg]
    keep = (pos_in_seg < (c if limit is None else limit[seg])) & (sorted_e < e)
    sentinel = e * c
    slot = torch.where(keep, sorted_e * c + pos_in_seg,
                       torch.full_like(pos_in_seg, sentinel))
    token_of = order // k
    # (E*C + 1,) buffers: every dropped assignment lands on the last entry,
    # which is sliced off (the reference's mode="drop")
    slot_token = torch.full((sentinel + 1,), t, dtype=torch.long,
                            device=dev).scatter(0, slot, token_of)[:sentinel]
    w_sorted = w.reshape(-1)[order]
    slot_w = torch.zeros((sentinel + 1,), dtype=w.dtype,
                         device=dev).scatter(0, slot, w_sorted)[:sentinel]
    # the inverse map: each assignment's slot in token-major order (order
    # is a permutation, so every entry is written once), then each token's
    # k slots ascending, the order the reference's scatter-add adds them
    flat_slot = torch.empty_like(slot).scatter(0, order, slot)
    token_slots = torch.sort(flat_slot.reshape(t, k), dim=-1).values
    return _Dispatch(slot_token, slot_w, token_slots)


def _experts(p, x: torch.Tensor, dsp: _Dispatch, e: int, c: int
             ) -> torch.Tensor:
    """The slots' expert outputs times their router weights, (E*C + 1, d)
    with a zero sentinel row last (the combine's dropped assignments)."""
    d = x.shape[-1]
    x_pad = torch.cat([x, x.new_zeros((1, d))])            # sentinel row
    xin = x_pad[dsp.slot_token].reshape(e, c, d)
    h = torch.bmm(xin, p["wi"].to(x.dtype))
    g = torch.bmm(xin, p["wg"].to(x.dtype))
    out = torch.bmm(F.silu(g) * h, p["wo"].to(x.dtype))
    upd = out.reshape(e * c, d) * dsp.slot_w[:, None]
    return torch.cat([upd, upd.new_zeros((1, d))])


def _combine(upd_pad: torch.Tensor, token_slots: torch.Tensor
             ) -> torch.Tensor:
    """Each token's rows summed in the order of ``token_slots``' columns
    (ascending slots): y = ((0 + u_1) + u_2) + ..., as the reference's
    scatter-add into zeros."""
    rows = upd_pad[token_slots]                            # (T, k, d)
    y = rows[:, 0]
    for j in range(1, rows.shape[1]):
        y = y + rows[:, j]
    return y


# The context whose ranks share a microbatch's capacity (see
# shared_capacity); None: a layer routes its tokens alone.
_SHARED: list = [None]


@contextlib.contextmanager
def shared_capacity(coll):
    """Within the block, :func:`moe_apply` on a rank's tokens keeps what
    the reference's global step keeps of the whole microbatch: the
    ranks of ``coll`` (a ``CollectiveContext``) hold the microbatch's
    rows in rank order, and every layer call exchanges their counts. No
    exchange for ``coll`` None or of one rank. Every rank of the context
    must enter it and call the same layers."""
    prev = _SHARED[0]
    _SHARED[0] = coll if coll is not None and coll.p > 1 else None
    try:
        yield
    finally:
        _SHARED[0] = prev


def _lower_ranks(counts: torch.Tensor) -> torch.Tensor:
    """(L, E) the held ranks' assignments an expert -> (L, E) those of
    the ranks below each (the exclusive prefix over ranks)."""
    coll = _SHARED[0]
    every = coll.all_gather(counts[:, None], axis=0)[0]      # (p, E)
    below = torch.cumsum(every, 0) - every
    return below[coll.axis_rank().to(counts.device)]


class _LowerRanks(torch.autograd.Function):
    """``_lower_ranks`` for one rank's (E,) counts, and under ``vmap``
    over the held ranks (the training step's ``rank_grads``) for all of
    them at once: the rule sees the (L, E) counts whole, which a vmapped
    function cannot. Integer results, no gradient."""

    @staticmethod
    def forward(counts):
        return _lower_ranks(counts[None])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None

    @staticmethod
    def vmap(info, in_dims, counts):
        return _lower_ranks(counts.movedim(in_dims[0], 0)), 0


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (T, d) flattened tokens -> (T, d), at capacity
    ``capacity(cfg, T)`` (assignments past it dropped); under
    :func:`shared_capacity`, at the capacity of the p ranks' T tokens
    each, after the lower ranks' assignments."""
    t, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    w, eidx = _route(p, x, k)
    flat_e = eidx.reshape(-1)
    coll = _SHARED[0]
    if coll is None:
        c, limit = capacity(cfg, t), None
    else:
        cap = capacity(cfg, coll.p * t)
        c = min(cap, t)
        counts = (flat_e[None, :] == torch.arange(e, device=x.device)[:, None]
                  ).sum(-1)
        limit = torch.clamp(cap - _LowerRanks.apply(counts), 0, c)
    dsp = _dispatch(flat_e, w, t, k, e, c, limit)
    y = _combine(_experts(p, x, dsp, e, c), dsp.token_slots)
    if cfg.moe_shared_ff:
        y = y + mlp(p["shared"], cfg, x)
    return y


# --------------------------------------------------------------------------
# Serve-time dispatch (continuous batching, DESIGN.md §8)
# --------------------------------------------------------------------------

class ServeDispatch(NamedTuple):
    """How a decode step's expert dispatch crosses the expert shards at
    serve time.

    ``exchange`` is the planned combine exchange (built by the serve
    engine from the ServePlan and the comm executor): (p_shards, T, d)
    stacked per-expert-shard combine partials -> the summed (T, d).
    ``active``, a (T,) bool tensor on the step's device, masks the live
    request slots: retired or empty slots never take expert capacity or
    touch the wire."""

    active: torch.Tensor          # (T,) bool: live decode slots
    exchange: Callable            # (p_shards, T, d) -> (T, d)
    p_shards: int                 # expert-parallel world size


def moe_apply_serve(p, cfg: ModelConfig, x: torch.Tensor,
                    dispatch: ServeDispatch) -> torch.Tensor:
    """Serve-time variant of :func:`moe_apply` for one decode step.

    * drop-free capacity ``c = T``: a token's top-k experts are distinct,
      so no expert sees more than T rows, and an active token's output
      never depends on which other requests share the batch;
    * inactive slots are routed to the sentinel expert id E (dropped
      before packing), so they take no capacity and add no rows;
    * the combine is one partial per expert shard (shard s owns the
      experts [s*E/p, (s+1)*E/p)), each token's rows of the shard summed
      in ascending slot order, and the (p, T, d) partials summed through
      ``dispatch.exchange``, the seam where the ServePlan picks the dense
      sum or the row-stream wire."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = t                                      # drop-free serve capacity
    w, eidx = _route(p, x, k)
    live = dispatch.active[:, None].expand(t, k).reshape(-1)
    flat_e = torch.where(live, eidx.reshape(-1),
                         torch.full_like(eidx.reshape(-1), e))
    dsp = _dispatch(flat_e, w, t, k, e, c)
    upd_pad = _experts(p, x, dsp, e, c)
    p_sh = dispatch.p_shards
    if e % p_sh:
        raise ValueError(f"{e} experts do not split over {p_sh} shards")
    span = (e // p_sh) * c
    sentinel = e * c
    parts = []
    for s in range(p_sh):
        mine = (dsp.token_slots >= s * span) & (dsp.token_slots
                                                < (s + 1) * span)
        parts.append(_combine(upd_pad, torch.where(
            mine, dsp.token_slots, torch.full_like(dsp.token_slots,
                                                   sentinel))))
    y = dispatch.exchange(torch.stack(parts))
    if cfg.moe_shared_ff:
        y = y + mlp(p["shared"], cfg, x)
    return y
