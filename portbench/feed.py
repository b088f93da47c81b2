"""The benchmark's inputs, made from ``--seed`` on the device: the weights,
the token batches and the QSGD rounding bits. The program and the plain
reference are handed the same ones. Plain torch: nothing of the port.

Weights: one generator a dtype, one normal draw for every leaf of that
dtype, each leaf scaled by its init rule (the configuration file's
``init``: by leaf name, ``fan_in`` by default, 1/sqrt of the leaf's
second-to-last dim, the in-dim of ``x @ W``).

Tokens: a Zipf law over the vocabulary (natural text's shape: a few ids
take most of the draws), laid over the ids by a permutation fixed by the
traffic mix, so every seed sees the same frequencies and draws other
rows. ``labels`` are the tokens (the loss shifts them).

Bits: the uint32 words of rank r of bucket i at step s come from a
generator seeded from (seed, s, i, r), so each rank's draw stands alone
(one rank a process draws only its own) and every call with the same
arguments gives the same words.
"""
from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def mix(*parts: int) -> int:
    """A 63-bit generator seed from integers of any size."""
    h = 0x5EED
    for p in parts:
        h = (h * 1_000_003 + int(p)) & _MASK
        h = (h ^ (h >> 29)) * 0x9E3779B97F4A7C15 & _MASK
    return h


def _init_value(rule, std_default):
    if rule == "fan_in":
        return "normal", std_default
    if rule in ("ones", "zeros", "a_log"):
        return rule, None
    return "normal", float(rule)


def weights(seed: int, leaves: list, init: dict, device) -> dict:
    """``leaves``: [(path, shape, dtype)] in flat order -> {path: tensor}.
    Normal leaves of one dtype are one draw from one generator."""
    out: dict = {}
    by_dtype: dict = {}
    for path, shape, dtype in leaves:
        rule = init.get(path[-1], "fan_in")
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        kind, std = _init_value(rule, 1.0 / math.sqrt(fan_in))
        if kind == "normal":
            by_dtype.setdefault(dtype, []).append((path, shape, std))
        elif kind == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:      # Mamba2's A_log: log(1 .. 16) over the heads (last dim)
            a = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                         dtype=torch.float32, device=device))
            out[path] = a.expand(shape).to(dtype).contiguous()
    for i, (dtype, group) in enumerate(sorted(by_dtype.items(),
                                              key=lambda kv: str(kv[0]))):
        gen = torch.Generator(device=device).manual_seed(mix(seed, 17, i))
        total = sum(math.prod(s) for _, s, _ in group)
        flat = torch.randn(total, generator=gen, dtype=torch.float32,
                           device=device)
        off = 0
        for path, shape, std in group:
            n = math.prod(shape)
            out[path] = (flat[off:off + n].view(shape) * std).to(dtype)
            off += n
        del flat
    return {p: out[p] for p, _, _ in leaves}


def nest(flat: dict) -> dict:
    """{path tuple: leaf} -> the nested dict the program takes."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


class Tokens:
    """The traffic mix's token batches: ``batch(step)`` -> {"tokens",
    "labels"} (global_batch, seq_len) int32 on the device."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        self.b, self.s = traffic["global_batch"], traffic["seq_len"]
        self.seed, self.device = seed, device
        law = traffic["tokens"]
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        p = ranks ** -float(law["exponent"])
        self.cdf = torch.cumsum(p / p.sum(), 0)
        gen = torch.Generator(device=device).manual_seed(
            mix(law["perm_seed"]))
        self.perm = torch.randperm(vocab, generator=gen, device=device)
        self.gen = torch.Generator(device=device)

    def batch(self, step: int) -> dict:
        self.gen.manual_seed(mix(self.seed, 23, step))
        u = torch.rand(self.b * self.s, generator=self.gen,
                       dtype=torch.float64, device=self.device)
        idx = torch.searchsorted(self.cdf, u).clamp_max_(len(self.perm) - 1)
        tok = self.perm[idx].view(self.b, self.s).to(torch.int32)
        return {"tokens": tok, "labels": tok}


class Bits:
    """QSGD rounding bits of one step over ``ranks`` ranks: called for n
    words (bucket ``i``), every rank's n/ranks words in rank order, the
    layout the port's executors read; ``rank_fn(r)`` gives rank r's own."""

    def __init__(self, seed: int, step: int, device, ranks: int):
        self.seed, self.step, self.device, self.ranks = seed, step, device, ranks
        self.gen = torch.Generator(device=device)

    def draw(self, bucket_idx: int, rank: int, n: int, out=None):
        self.gen.manual_seed(mix(self.seed, 29, self.step, bucket_idx, rank))
        words = (torch.empty(n, dtype=torch.int32, device=self.device)
                 if out is None else out)
        words.random_(-2**31, 2**31, generator=self.gen)
        return words.view(torch.uint32)

    def rank_fn(self, rank: int):
        return lambda bucket_idx, n: self.draw(bucket_idx, rank, n)

    def __call__(self, bucket_idx: int, n: int) -> torch.Tensor:
        if n % self.ranks:
            raise ValueError(f"{n} words do not split over {self.ranks} ranks")
        m = n // self.ranks
        out = torch.empty(n, dtype=torch.int32, device=self.device)
        for r in range(self.ranks):
            self.draw(bucket_idx, r, m, out=out[r * m:(r + 1) * m])
        return out.view(torch.uint32)
