"""Synthetic high-dimensional sparse classification data (paper §8.2).

Mimics the URL / Webspam datasets: trigram-style features — each sample
touches a tiny subset of a huge feature space, so gradients of linear
models are NATURALLY sparse (the paper's 'lossless' sparsity case)."""
from __future__ import annotations

import numpy as np


def make_url_like_dataset(
    n_samples: int = 4096,
    n_features: int = 1 << 20,
    nnz_per_sample: int = 64,
    seed: int = 0,
):
    """Returns (indices (S, nnz), values (S, nnz), labels (S,) in {-1,+1}).

    Ground truth: a sparse linear separator over a small subset of
    features, so logistic regression is learnable."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_features, size=(n_samples, nnz_per_sample)).astype(np.int32)
    val = rng.exponential(1.0, size=(n_samples, nnz_per_sample)).astype(np.float32)
    w_true_idx = rng.choice(n_features, size=2048, replace=False)
    w_true = np.zeros(n_features, np.float32)
    w_true[w_true_idx] = rng.standard_normal(2048)
    margins = (val * w_true[idx]).sum(axis=1)
    labels = np.where(margins + 0.1 * rng.standard_normal(n_samples) > 0, 1.0, -1.0)
    return idx, val, labels.astype(np.float32)
