"""SparCML's gradient exchange (paper Alg. 2 with DSAR and QSGD) and
AdamW, in plain PyTorch, for R data-parallel ranks.

Layout (the port's plan, which decides what falls into one top-k bucket):

* each leaf in a canonical (rows, cols) form: the axis its layout shards
  over the model moved to the front as the rows (one row if none), the
  rest flattened and zero-padded to a multiple of the bucket size;
* leaves of one row count fused along the columns, in flat leaf order
  (sorted keys, depth first), one-row leaves first, then by rows;
* each fused buffer padded to a multiple of q = lcm(bucket, QSGD bucket)
  * R columns and cut into fusion buckets of at most 4 MiB of f32
  (a multiple of q), numbered in that order;
* a bucket of fewer than ``min_sparse_size`` entries is summed densely.

Per sparse bucket and rank: acc = residual + grads; keep the k largest
|acc| of every ``bucket_size`` consecutive entries of a row (ties to the
lower index), the rest is the new residual. The kept entries are summed
over the ranks in rank order. DSAR's second phase quantizes that sum with
QSGD: each rank owns a 1/R range of every row's columns, cut into QSGD
rows of ``qsgd_bucket`` entries (ranks, then rows, then position: the
order the bits are laid out in), each coded as sign * floor(|x| / ||row||
* s + u) with s = 2^(bits-1) - 1 levels and u the row's bits / 2^32,
and decoded as code * (||row|| * (1/s)). The mean divides by R.

AdamW then runs on the synced gradients clipped to a global norm; ZeRO-1
only splits which rank updates which columns, so elementwise it is AdamW
on the whole leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

f32 = torch.float32


def model_axis(path: tuple, ndim: int):
    """The dim the port's layout shards over the model, or None."""
    name, in_moe = path[-1], "moe" in path
    if name in ("embed", "unembed"):
        return 1
    if in_moe and name in ("wi", "wg", "wo"):
        return ndim - 3
    if name in ("wq", "wk", "wv", "wi", "wg", "in_proj"):
        return ndim - 1
    if name in ("wo", "out_proj"):
        return ndim - 2
    return None


def canonical(x: torch.Tensor, ax, bucket: int) -> torch.Tensor:
    if ax is None or x.dim() <= 1:
        flat = x.reshape(1, -1)
    else:
        flat = torch.movedim(x, ax, 0).reshape(x.shape[ax], -1)
    pad = -flat.shape[1] % bucket
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def from_canonical(c: torch.Tensor, shape: tuple, ax) -> torch.Tensor:
    if ax is None or len(shape) <= 1:
        return c.reshape(-1)[:math.prod(shape)].reshape(shape)
    moved = (shape[ax],) + tuple(s for i, s in enumerate(shape) if i != ax)
    out = c[:, :math.prod(moved[1:])].reshape(moved)
    return torch.movedim(out, 0, ax)


@dataclass
class Slot:
    path: tuple
    shape: tuple
    ax: object
    rows: int
    cols: int
    offset: int


@dataclass
class Bucket:
    index: int
    group: int
    rows: int
    start: int
    cols: int
    sparse: bool


class Layout:
    """The groups and buckets of the leaves ``shapes`` ({path: shape}, in
    flat order) for R ranks under the sync settings ``sync``."""

    def __init__(self, shapes: dict, sync: dict, ranks: int):
        b = sync["bucket_size"]
        q = math.lcm(b, sync["qsgd_bucket"]) * ranks
        by_rows: dict = {}
        for path, shape in shapes.items():
            ax = model_axis(path, len(shape))
            rows = shape[ax] if ax is not None and len(shape) > 1 else 1
            cols = -(-(math.prod(shape) // rows) // b) * b
            by_rows.setdefault(rows, []).append((path, shape, ax, rows, cols))
        self.groups, self.buckets = [], []
        for gid, rows in enumerate(sorted(by_rows, key=lambda r: (r != 1, r))):
            slots, off = [], 0
            for path, shape, ax, r, cols in by_rows[rows]:
                slots.append(Slot(path, shape, ax, r, cols, off))
                off += cols
            total = -(-off // q) * q
            cap = max(q, sync["fusion_bucket_bytes"] // 4 // rows // q * q)
            start = 0
            while start < total:
                take = min(cap, total - start)
                self.buckets.append(Bucket(
                    len(self.buckets), gid, rows, start, take,
                    rows * take >= sync["min_sparse_size"]))
                start += take
            self.groups.append((rows, total, slots))

    def pack(self, gid: int, leaves: dict, bucket: int) -> torch.Tensor:
        rows, total, slots = self.groups[gid]
        buf = torch.cat([canonical(leaves[s.path].to(f32), s.ax, bucket)
                         for s in slots], dim=1)
        return torch.nn.functional.pad(buf, (0, total - buf.shape[1]))

    def unpack(self, gid: int, buf: torch.Tensor) -> dict:
        _, _, slots = self.groups[gid]
        return {s.path: from_canonical(buf[:, s.offset:s.offset + s.cols],
                                       s.shape, s.ax) for s in slots}


def topk_split(acc: torch.Tensor, k: int, bucket: int):
    """(kept, residual): the k largest |acc| of each run of ``bucket``
    entries (ties to the lower index), and the rest."""
    rows = acc.reshape(-1, bucket)
    order = torch.sort(rows.abs(), dim=1, descending=True, stable=True).indices
    mask = torch.zeros_like(rows, dtype=torch.bool).scatter_(
        1, order[:, :k], True)
    kept = torch.where(mask, rows, torch.zeros_like(rows))
    return kept.view_as(acc), (rows - kept).view_as(acc)


def qsgd_roundtrip(s: torch.Tensor, words: torch.Tensor, ranks: int,
                   bits: int, qbucket: int) -> torch.Tensor:
    """The summed bucket (rows, cols) quantized and decoded with the
    bucket's rounding bits (``words``: rows * cols uint32, rank-major)."""
    rows, cols = s.shape
    shard = cols // ranks
    x = s.view(rows, ranks, shard).permute(1, 0, 2).reshape(-1, qbucket)
    levels = 2 ** (bits - 1) - 1
    norm = torch.sqrt((x * x).sum(1, keepdim=True))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    u = (words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).to(f32)
    u = u.view(x.shape) * 2.0 ** -32
    level = torch.floor(x.abs() / safe * levels + u).clamp(0, levels)
    code = torch.where(x < 0, -level, level)
    code = torch.where(norm > 0, code, torch.zeros_like(code))
    step = norm * torch.tensor(1.0 / levels, dtype=f32)
    out = (code * step).view(ranks, rows, shard).permute(1, 0, 2)
    return out.reshape(rows, cols)


class Sync:
    """Error-feedback state and the exchange of one step. ``fault``:
    "no_exchange" sums rank 0's kept entries alone (the other ranks' never
    reach the sum), the exchange left out."""

    def __init__(self, layout: Layout, sync: dict, ranks: int, device,
                 fault: str | None = None):
        want = {"mode": "sparcml", "algorithm": "dsar_split_allgather",
                "qsgd_scale": "l2", "mean": True, "output_mode": "replicated"}
        for k, v in want.items():
            if sync.get(k, v) != v:
                raise ValueError(f"the reference's sync runs {k}={v!r}, not "
                                 f"{sync[k]!r}")
        self.layout, self.sync, self.ranks, self.fault = layout, sync, ranks, fault
        self.residual = {b.index: torch.zeros(ranks, b.rows, b.cols,
                                              dtype=f32, device=device)
                         for b in layout.buckets if b.sparse}

    def step(self, rank_grads, bits) -> dict:
        """``rank_grads(r)`` -> rank r's f32 grads {path: tensor}; ``bits``
        (bucket index, n words) -> uint32 words. Returns the synced mean
        gradient {path: tensor}."""
        cfg, lay, p = self.sync, self.layout, self.ranks
        sums = {b.index: torch.zeros(b.rows, b.cols, dtype=f32,
                                     device=self._dev())
                for b in lay.buckets}
        for r in range(p):
            grads = rank_grads(r)
            for gid in range(len(lay.groups)):
                buf = lay.pack(gid, grads, cfg["bucket_size"])
                for b in (b for b in lay.buckets if b.group == gid):
                    contrib = buf[:, b.start:b.start + b.cols]
                    if b.sparse:
                        acc = self.residual[b.index][r] + contrib
                        contrib, self.residual[b.index][r] = topk_split(
                            acc, cfg["k_per_bucket"], cfg["bucket_size"])
                    if self.fault != "no_exchange" or r == 0:
                        sums[b.index] += contrib
                del buf
            del grads
        flat: dict = {}
        for gid, (rows, total, _) in enumerate(lay.groups):
            parts = []
            for b in (b for b in lay.buckets if b.group == gid):
                s = sums.pop(b.index)
                if b.sparse and cfg["qsgd_bits"]:
                    s = qsgd_roundtrip(s, bits(b.index, b.rows * b.cols), p,
                                       cfg["qsgd_bits"], cfg["qsgd_bucket"])
                parts.append(s / p)
            flat.update(lay.unpack(gid, torch.cat(parts, dim=1)))
        return flat

    def _dev(self):
        return next(iter(self.residual.values())).device


def lr_at(step: int, opt: dict) -> float:
    """Cosine decay after a linear warm-up."""
    warm = min(step / max(1, opt["warmup_steps"]), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0), 1.0)
    frac = opt["final_frac"] + (1 - opt["final_frac"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return opt["peak_lr"] * warm * frac


def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * factor for k, g in grads.items()}


class AdamW:
    def __init__(self, params: dict, opt: dict):
        self.opt, self.count = opt, 0
        self.m = {k: torch.zeros(p.shape, dtype=f32, device=p.device)
                  for k, p in params.items()}
        self.v = {k: torch.zeros(p.shape, dtype=f32, device=p.device)
                  for k, p in params.items()}

    def update(self, params: dict, grads: dict, lr: float) -> dict:
        o = self.opt
        self.count += 1
        c1, c2 = 1 - o["beta1"] ** self.count, 1 - o["beta2"] ** self.count
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = o["beta1"] * self.m[k] + (1 - o["beta1"]) * g
            self.v[k] = o["beta2"] * self.v[k] + (1 - o["beta2"]) * g * g
            delta = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + o["eps"])
            pf = p.to(f32)
            out[k] = (pf - lr * (delta + o["weight_decay"] * pf)).to(p.dtype)
        return out
