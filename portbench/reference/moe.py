"""The ``moe`` family: every layer attention then a mixture of experts
(softmax router, top-k renormalised, SwiGLU experts, a shared expert),
routed tokens past an expert's capacity dropped in token order."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import (Prec, dense_block, lm_loss,
                                        padded_vocab, swiglu)

f32 = torch.float32


def param_shapes(dims: dict) -> dict:
    """{path: (shape, dtype)} of the weights, in the port's layout: the
    layers stacked on a leading axis."""
    d, v, n = dims["d_model"], padded_vocab(dims), dims["num_layers"]
    nh, nkv, hd = dims["num_heads"], dims["num_kv_heads"], dims["head_dim"]
    e, ff, sff = dims["num_experts"], dims["moe_d_ff"], dims["moe_shared_ff"]
    pdt = dims["param_dtype"]
    out = {("embed",): ((v, d), pdt), ("final_norm", "scale"): ((d,), pdt),
           ("unembed",): ((d, v), pdt)}
    blk = {("ln1", "scale"): ((n, d), pdt), ("ln2", "scale"): ((n, d), pdt),
           ("attn", "wq"): ((n, d, nh * hd), pdt),
           ("attn", "wk"): ((n, d, nkv * hd), pdt),
           ("attn", "wv"): ((n, d, nkv * hd), pdt),
           ("attn", "wo"): ((n, nh * hd, d), pdt),
           ("moe", "router"): ((n, d, e), f32),
           ("moe", "wi"): ((n, e, d, ff), pdt),
           ("moe", "wg"): ((n, e, d, ff), pdt),
           ("moe", "wo"): ((n, e, ff, d), pdt)}
    if sff:
        blk.update({("moe", "shared", "wi"): ((n, d, sff), pdt),
                    ("moe", "shared", "wg"): ((n, d, sff), pdt),
                    ("moe", "shared", "wo"): ((n, sff, d), pdt)})
    out.update({("blocks",) + k: s for k, s in blk.items()})
    return out


def capacity(dims: dict, tokens: int) -> int:
    """Slots an expert: capacity_factor * tokens * k / E, at least 8 and
    rounded up to a multiple of 8."""
    c = int(dims["capacity_factor"] * tokens * dims["experts_per_token"]
            / dims["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe(p: dict, dims: dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """x (T, d) -> (T, d)."""
    t = x.shape[0]
    e, k = dims["num_experts"], dims["experts_per_token"]
    gates = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    w, eidx = torch.topk(gates, k, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    # an assignment is kept while fewer than C earlier ones (token-major:
    # token, then its rank among its k) went to the same expert
    flat = eidx.reshape(-1)
    onehot = F.one_hot(flat, e)
    before = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = before < capacity(dims, t)
    y = torch.zeros_like(x)
    wf = w.reshape(-1)
    for ex in range(e):
        sel = torch.nonzero(keep & (flat == ex))[:, 0]
        if sel.numel() == 0:
            continue
        tok = sel // k
        pe = {"wi": p["wi"][ex], "wg": p["wg"][ex], "wo": p["wo"][ex]}
        y = y.index_add(0, tok, swiglu(pe, x[tok], prec) * wf[sel, None])
    if "shared" in p:
        y = y + swiglu(p["shared"], x, prec)
    return y


def loss(params: dict, dims: dict, batch: dict, prec: Prec) -> torch.Tensor:
    """Mean next-token loss of one microbatch; params in float32."""
    toks = batch["tokens"].long()
    x = prec.act(params["embed"][toks])
    b, s, d = x.shape
    blocks = params["blocks"]
    for i in range(dims["num_layers"]):
        lp = _layer(blocks, i)

        def ffn(h, lp=lp):
            return moe(lp["moe"], dims, h.reshape(b * s, d), prec).view(b, s, d)

        x = dense_block(lp, dims, x, ffn, prec)
    return lm_loss(params, dims, x, batch["labels"], prec)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
