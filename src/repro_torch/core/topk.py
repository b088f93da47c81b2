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

from repro_torch.core.sparse_stream import SparseStream
from repro_torch.kernels.bucket_scatter.ops import bucket_scatter
from repro_torch.kernels.bucket_topk.ops import bucket_topk


class UniformStream(NamedTuple):
    """A bucket-uniform sparse vector: exactly k entries per B-wide bucket.

    lidx: (*lead, nb, k) int32, ascending within bucket, values in [0, B)
    val:  (*lead, nb, k)
    Global index of entry (r, j) = r * B + lidx[r, j]; total length nb * B.
    The optional leading axes hold independent vectors (the ranks a
    process holds in the per-rank collectives).
    """

    lidx: torch.Tensor
    val: torch.Tensor
    bucket_size: int

    @property
    def num_buckets(self) -> int:
        return self.lidx.shape[-2]

    @property
    def k(self) -> int:
        return self.lidx.shape[-1]

    @property
    def n(self) -> int:
        return self.num_buckets * self.bucket_size

    @property
    def nnz(self) -> int:
        return self.num_buckets * self.k

    def to_stream(self) -> SparseStream:
        """Flat global-index stream (sorted: buckets are contiguous)."""
        *lead, nb, k = self.lidx.shape
        base = torch.arange(nb, dtype=torch.int32,
                            device=self.lidx.device)[:, None] * self.bucket_size
        return SparseStream(
            idx=(base + self.lidx).reshape(*lead, nb * k),
            val=self.val.reshape(*lead, nb * k),
            nnz=torch.full(tuple(lead), nb * k, dtype=torch.int32,
                           device=self.lidx.device))

    def densify(self, impl: str = "auto") -> torch.Tensor:
        """(*lead, nb*B) through ``bucket_scatter``."""
        *lead, nb, k = self.lidx.shape
        return bucket_scatter(self.lidx.reshape(-1, k), self.val.reshape(-1, k),
                              self.bucket_size, impl=impl).reshape(
                                  *lead, nb * self.bucket_size)


def compress(x: torch.Tensor, k_per_bucket: int, bucket_size: int = 512,
             impl: str = "auto") -> tuple[UniformStream, torch.Tensor]:
    """TopK-compress a vector (n,) or a batch of vectors (*lead, n).
    Returns (stream, residual).

    x is zero-padded up to a bucket multiple. residual = x with the
    selected entries zeroed, restricted to the original length.
    """
    *lead, n = x.shape
    nb = -(-n // bucket_size)
    pad = nb * bucket_size - n
    xp = F.pad(x, (0, pad)) if pad else x
    val, lidx, res = bucket_topk(xp.reshape(-1, bucket_size), k_per_bucket,
                                 impl=impl)
    k = k_per_bucket
    return (UniformStream(lidx.reshape(*lead, nb, k), val.reshape(*lead, nb, k),
                          bucket_size),
            res.reshape(*lead, nb * bucket_size)[..., :n])


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
