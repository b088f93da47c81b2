"""Stochastic density analysis (paper Appendix B).

Expected fill-in of the reduced result when each of P nodes contributes k
uniformly-random non-zero indices out of N. Drives algorithm selection
(SSAR vs DSAR) and reproduces Fig. 1 / Fig. 7. Host arithmetic only; the
Monte Carlo check draws with numpy from an explicit seed.
"""
from __future__ import annotations

import numpy as np


def expected_nnz(k: int, n: int, p: int) -> float:
    """E[K] under uniform sparsity.

    Closed form: the inclusion-exclusion sum in App. B.1 telescopes to
    N * (1 - (1 - k/N)^P) when the k draws per node are i.i.d. uniform.
    """
    if k <= 0:
        return 0.0
    d = min(1.0, k / n)
    return n * (1.0 - (1.0 - d) ** p)


def expected_nnz_inclusion_exclusion(k: int, n: int, p: int) -> float:
    """The paper's literal alternating-series form (App. B.1), for validation.

    E[K] = N * sum_{i=1..P} (-1)^{i-1} C(P,i) (k/N)^i
    Matches `expected_nnz` because sum_{i} C(P,i)(-d)^i = (1-d)^P - 1.
    Computed in log-space-free float; fine for the P<=4096 we use in tests.
    """
    d = k / n
    total = 0.0
    term = 1.0  # C(P, i) * d^i, built incrementally
    for i in range(1, p + 1):
        term = term * (p - i + 1) / i * d if i > 1 else p * d
        total += (-1) ** (i - 1) * term
        if term < 1e-18:  # series tail is negligible
            break
    return n * total


def monte_carlo_nnz(k: int, n: int, p: int, trials: int = 16, seed: int = 0) -> float:
    """Empirical E[K]: sample P nodes x k uniform indices, count the union."""
    rng = np.random.default_rng(seed)
    counts = []
    for _ in range(trials):
        union = np.zeros(n, dtype=bool)
        for _ in range(p):
            union[rng.choice(n, size=k, replace=False)] = True
        counts.append(int(union.sum()))
    return float(np.mean(counts))


def reduced_density(k: int, n: int, p: int) -> float:
    """Fig. 1 quantity: density (fraction) of the reduced result."""
    return expected_nnz(k, n, p) / n


def fill_in_factor(k: int, n: int, p: int) -> float:
    """Fig. 7 quantity: multiplicative growth E[K]/k."""
    return expected_nnz(k, n, p) / max(1, k)
