"""Rows that stress bucket_topk's selection rule.

The tests and ``chip_smoke.py`` hold the kernel to its plain version on
these as well as on Gaussian rows: the selection compares the bit
patterns of |x|, so signed zeros, infinities, denormals, long runs of one
magnitude and keys that agree in all but their lowest bits are where a
radix select's digit passes and its tie rule can go wrong. The
non-finite rows (NaN, Inf) are also what the reduce half's other kernels
(qsgd_pack, bucket_scatter_sum) see after an injected fault.
"""
from __future__ import annotations

import torch

ONE_BITS = 0x3F800000   # the bits of 1.0f


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).view(torch.float32)


def adversarial_rows(n: int, b: int, seed: int = 0) -> dict:
    """name -> (n, b) float32 CPU rows, each row drawn on its own."""
    g = torch.Generator().manual_seed(seed)
    sign = torch.where(torch.rand((n, b), generator=g) < 0.5, -1.0, 1.0)
    normal = torch.randn((n, b), generator=g)
    few = torch.rand((n, b), generator=g) < 4.0 / b        # ~4 a row
    denormal = _bits(torch.randint(1, 1 << 23, (n, b), generator=g)) * sign
    near_one = _bits(ONE_BITS + torch.randint(0, 8, (n, b), generator=g))
    extremes = torch.tensor([0.0, -0.0, torch.finfo(torch.float32).max,
                             -torch.finfo(torch.float32).max,
                             float(_bits(torch.tensor(1))), 1.0])
    return {
        # every key ties: the k lowest indices win
        "one_magnitude": 0.75 * sign,
        "signed_zeros": 0.0 * sign,
        "infinities": torch.where(few, float("inf") * sign, normal),
        "all_infinite": float("inf") * sign,
        "denormals": denormal,
        "denormals_few_normal": torch.where(few, normal, denormal),
        # many keys equal the k-th one
        "ties_at_threshold": torch.round(normal * 2) / 2,
        # keys that differ only in their lowest 3 bits: every digit pass
        "low_bits_only": near_one * sign,
        "extremes": extremes[torch.randint(0, len(extremes), (n, b),
                                           generator=g)],
    }


def nonfinite_rows(n: int, b: int, seed: int = 0) -> dict:
    """name -> (n, b) float32 CPU rows holding NaN and Inf, the values an
    injected fault (or a diverging step) hands the reduce half: the guard
    discards its results, but the kernels still run on them. One NaN bit
    pattern of each sign (a computed NaN's payload is the device's own),
    so the selection's keys compare alike in the kernel and the plain
    version; the magnitude of a NaN's bits lies above Inf's."""
    g = torch.Generator().manual_seed(seed)
    sign = torch.where(torch.rand((n, b), generator=g) < 0.5, -1.0, 1.0)
    normal = torch.randn((n, b), generator=g)
    few = torch.rand((n, b), generator=g) < 4.0 / b
    more = torch.rand((n, b), generator=g) < 16.0 / b
    nan = torch.full((), float("nan"))
    signed_nan = torch.where(sign < 0, -nan, nan)
    return {
        "nan_few": torch.where(few, signed_nan, normal),
        "nan_many": torch.where(more, signed_nan, normal),
        "all_nan": signed_nan.expand(n, b).clone(),
        "nan_and_inf": torch.where(few, signed_nan,
                                   torch.where(more, float("inf") * sign,
                                               normal)),
        "inf_both_signs": torch.where(more, float("inf") * sign, normal),
    }
