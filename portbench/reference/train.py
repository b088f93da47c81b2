"""The first steps of a SparCML training cell, in the plain reference:
R ranks each take a contiguous 1/R of the global batch's rows, in
microbatches of consecutive rows, and average their microbatches' float32
gradients; the sync (``sync.Sync``) averages the ranks; the synced
gradients are clipped and AdamW steps the weights, kept in their
configured dtype.

``run`` returns what the benchmark compares: each step's loss (the mean
over ranks of the mean over microbatches), each leaf's norm of the first
step's clipped synced gradient (what the optimizer is handed) and of its
raw mean gradient, each EF bucket's residual norm on each rank after the
first step, and each leaf's norm of the change of its weights over the
steps. Faults for reading the limits' upper ends: ``half_batch``
(each rank uses the first half of its microbatches, the mean taken over
those) and ``no_exchange`` (see ``sync.Sync``)."""
from __future__ import annotations

import torch

from portbench.reference import moe
from portbench.reference.layers import Prec
from portbench.reference.sync import AdamW, Layout, Sync, clip, lr_at

FAMILIES = {"moe": moe}
f32 = torch.float32


def family(dims: dict):
    return FAMILIES[dims["family"]]


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def run(dims: dict, settings: dict, weights: dict, batch_at, bits_at,
        steps: int = 3, prec: Prec | None = None,
        fault: str | None = None) -> dict:
    """``weights``: {path: tensor} in flat order; ``batch_at(step)``: the
    global batch; ``bits_at(step)``: the step's (bucket, n) -> words;
    ``settings``: ranks, microbatches, start_step, sync, optimizer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec = prec or Prec()
    mod = family(dims)
    p, n_micro = settings["ranks"], settings["microbatches"]
    used = n_micro // 2 if fault == "half_batch" else n_micro
    layout = Layout({k: tuple(v.shape) for k, v in weights.items()},
                    settings["sync"], p)
    dev = next(iter(weights.values())).device
    sync = Sync(layout, settings["sync"], p, dev,
                fault if fault == "no_exchange" else None)
    opt = AdamW(weights, settings["optimizer"])
    params = dict(weights)
    out = {"losses": [], "grad_norms": {}, "raw_norms": {}}
    for i in range(steps):
        step = settings["start_step"] + i
        batch = batch_at(step)
        rows = next(iter(batch.values())).shape[0]
        per_rank, mb = rows // p, rows // (p * n_micro)
        leaves = {k: v.to(f32, copy=True).requires_grad_()
                  for k, v in params.items()}
        tree = _nest(leaves)
        losses, raw = [], {}

        def rank_grads(r):
            acc = None
            loss_sum = 0.0
            for j in range(used):
                lo = r * per_rank + j * mb
                part = {k: v[lo:lo + mb] for k, v in batch.items()}
                loss = mod.loss(tree, dims, part, prec)
                gs = torch.autograd.grad(loss, list(leaves.values()))
                loss_sum += float(loss.detach())
                acc = list(gs) if acc is None else [a + g for a, g in
                                                    zip(acc, gs)]
            losses.append(loss_sum / used)
            grads = {k: g / used for k, g in zip(leaves, acc)}
            if i == 0:
                for k, g in grads.items():
                    raw[k] = raw[k] + g if k in raw else g.clone()
            return grads

        synced = clip(sync.step(rank_grads, bits_at(step)),
                      settings["optimizer"]["grad_clip"])
        if i == 0:
            out["grad_norms"] = {k: float(g.norm()) for k, g in synced.items()}
            out["residual_norms"] = [
                sync.residual[b.index].flatten(1).norm(dim=1).tolist()
                for b in layout.buckets if b.sparse]
            out["raw_norms"] = {k: float((g / p).norm())
                                for k, g in raw.items()}
        del leaves, tree, raw
        params = opt.update(params, synced, lr_at(step, settings["optimizer"]))
        del synced
        out["losses"].append(sum(losses) / p)
    out["change_norms"] = {k: float((params[k].to(f32) - weights[k].to(f32))
                                    .norm()) for k in params}
    return out
