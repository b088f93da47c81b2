"""Bucketed TopK sparsification with error feedback (paper Alg. 2, §8.3).

The paper selects k entries out of every bucket of 512 consecutive
gradient values. Bucketing makes per-index-range counts exactly uniform,
so the split phase of the allreduce needs no dynamic message sizes.

Both compression entry points go through the ``bucket_topk`` kernel and
densification through ``bucket_scatter`` (on a CUDA tensor the
hand-written kernels, on a CPU tensor their plain versions).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.bucket_scatter.ops import bucket_scatter
from repro_torch.kernels.bucket_topk.ops import bucket_topk


class UniformStream(NamedTuple):
    """A bucket-uniform sparse vector: exactly k entries per B-wide bucket.

    lidx: (nb, k) int32, ascending within bucket, values in [0, B)
    val:  (nb, k)
    Global index of entry (r, j) = r * B + lidx[r, j]; total length nb * B.
    """

    lidx: torch.Tensor
    val: torch.Tensor
    bucket_size: int

    def densify(self, impl: str = "auto") -> torch.Tensor:
        return bucket_scatter(self.lidx, self.val, self.bucket_size,
                              impl=impl).reshape(-1)


def compress(x: torch.Tensor, k_per_bucket: int, bucket_size: int = 512,
             impl: str = "auto") -> tuple[UniformStream, torch.Tensor]:
    """TopK-compress a flat vector. Returns (stream, residual).

    x is zero-padded up to a bucket multiple. residual = x with the
    selected entries zeroed, restricted to the original length.
    """
    (n,) = x.shape
    nb = -(-n // bucket_size)
    pad = nb * bucket_size - n
    xp = F.pad(x, (0, pad)) if pad else x
    val, lidx, res = bucket_topk(xp.reshape(nb, bucket_size), k_per_bucket,
                                 impl=impl)
    return UniformStream(lidx, val, bucket_size), res.reshape(-1)[:n]


class BatchedStream(NamedTuple):
    """Bucket-uniform stream with leading batch axes (the canonical row
    axis and, in the stacked-replica form, the replica axis).

    lidx/val: (*lead, m, k) — lead batch dims, m buckets each.
    """

    lidx: torch.Tensor
    val: torch.Tensor
    bucket_size: int

    def densify(self, impl: str = "auto") -> torch.Tensor:
        """(*lead, m*B) through ``bucket_scatter``."""
        *lead, m, k = self.lidx.shape
        b = self.bucket_size
        dense = bucket_scatter(self.lidx.reshape(-1, k),
                               self.val.reshape(-1, k), b, impl=impl)
        return dense.reshape(*lead, m * b)


def compress2d(x: torch.Tensor, k_per_bucket: int, bucket_size: int = 512,
               impl: str = "auto") -> tuple[BatchedStream, torch.Tensor]:
    """Batched TopK compression of a canonical (*lead, cols) layout.

    Returns (stream, residual (*lead, cols)); the leading dims are only
    flattened into the kernel's row axis and restored after it."""
    *lead, cols = x.shape
    b = bucket_size
    if cols % b:
        raise ValueError(f"compress2d: cols {cols} not a multiple of {b}")
    m = cols // b
    val, lidx, res = bucket_topk(x.reshape(-1, b), k_per_bucket, impl=impl)
    k = k_per_bucket
    stream = BatchedStream(lidx.reshape(*lead, m, k), val.reshape(*lead, m, k),
                           b)
    return stream, res.reshape(*lead, cols)
