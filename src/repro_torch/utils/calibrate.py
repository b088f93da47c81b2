"""One-shot alpha-beta network calibration (the JAX package's
``repro.utils.calibrate``).

The cost model holds no network constants (``core/cost_model.py``): the
paper's point (§5.3) is that algorithm selection should use the
*machine's* alpha and beta, fitted from allreduce timings. This module
times the dense allreduce of a replicated N-vector on a collectives
context at a ladder of message sizes and least-squares fits

    T(L) = alpha' + L * beta'   =>   NetworkParams(alpha, link_bytes_per_s)

where the Rabenseifner accounting (2 log2(P) alpha + 2 (P-1)/P N beta_d)
is inverted so the fitted per-hop alpha and per-byte beta plug straight
into the ``t_*`` formulas.

What the fit describes is the context's allreduce: over
``ProcessGroupCollectives`` a wire (gloo on the CPU, NCCL between
cards); over ``StackedCollectives`` on one device, the device's sum over
the rank axis, which moves no byte between ranks. A replan driven by
the latter tests the adaptive loop; it is not a network choice.

Each point is the median of ``repeats`` timed calls after a warm-up (CUDA
events on a card, the host clock on the CPU). The reference's ladder
(``DEFAULT_SIZES``, 2^12 to 2^20 elements) sits in the launch-latency
regime on a card, where the slope can fit <= 0; ``calibrate`` takes
``CARD_SIZES`` (up to 2^26 elements) there. Unlike the reference, which
falls back to its TPU constants, a degenerate fit raises
:class:`DegenerateFit`: the port has no constants to fall back to.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import NetworkParams, t_dense_allreduce

DEFAULT_SIZES = (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20)
CARD_SIZES = (1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26)


class DegenerateFit(ValueError):
    """The measured ladder does not fit the alpha-beta form (fewer than two
    points, or a slope that is not positive and finite)."""


def fit_network_params(sizes_bytes: Sequence[float],
                       times_s: Sequence[float],
                       p: int = 2,
                       isize: int = 4) -> NetworkParams:
    """Least-squares fit of measured dense-allreduce times to the
    Rabenseifner alpha-beta form; returns calibrated ``NetworkParams``.

    sizes_bytes: payload sizes N*isize of each measurement;
    times_s: matching times;
    p: world size the measurements ran at (fixes the latency/bandwidth
    prefactors so alpha/beta come out per-hop / per-byte).
    Raises :class:`DegenerateFit` where the reference returns its
    defaults."""
    sizes = np.asarray(sizes_bytes, dtype=np.float64)
    times = np.asarray(times_s, dtype=np.float64)
    if sizes.size < 2:
        raise DegenerateFit(f"{sizes.size} ladder point(s): the fit needs 2")
    # T = 2 log2(P) * alpha + 2 (P-1)/P * bytes * beta_byte
    lat_pref = 2.0 * math.log2(max(2, p))
    bw_pref = 2.0 * (p - 1) / p
    a = np.stack([np.full_like(sizes, lat_pref), bw_pref * sizes], axis=1)
    coef, *_ = np.linalg.lstsq(a, times, rcond=None)
    alpha, beta_byte = float(coef[0]), float(coef[1])
    if beta_byte <= 0.0 or not np.isfinite(beta_byte):
        raise DegenerateFit(
            f"the ladder fits a per-byte time of {beta_byte!r} s: no "
            "bandwidth term (sizes in the launch-latency regime, or noisy "
            "times); measure larger sizes")
    alpha = max(alpha, 1e-9)      # intercepts can fit slightly negative
    return NetworkParams(alpha=alpha, link_bytes_per_s=1.0 / beta_byte,
                         isize=isize)


def call_seconds(fn, device: torch.device) -> float:
    """The time of one call of ``fn`` in seconds: CUDA events around it on
    a card, the host clock on the CPU (where the call ends with its
    work)."""
    if device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) * 1e-3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure_allreduce_times(coll, sizes: Sequence[int] = DEFAULT_SIZES,
                            repeats: int = 5) -> list[tuple[int, float]]:
    """Median of ``repeats`` times of ``coll.psum`` over a replicated f32
    N-vector (every held rank contributes a full vector, so the timed sum
    is an allreduce of N elements, the N of ``t_dense_allreduce``) at each
    element count in ``sizes``, rounded down to a multiple of ``coll.p``.
    Returns [(payload_bytes, seconds), ...] for
    :func:`fit_network_params`."""
    out = []
    for n in sizes:
        n = max(int(n), coll.p)
        n -= n % coll.p
        x = torch.ones((coll.local_ranks, n), dtype=torch.float32,
                       device=coll.device)
        coll.psum(x)                              # warm-up, outside timing
        times = [call_seconds(lambda: coll.psum(x), coll.device)
                 for _ in range(max(1, repeats))]
        out.append((n * 4, statistics.median(times)))
        del x
    return out


def calibrate(coll, sizes: Optional[Sequence[int]] = None,
              repeats: int = 5, isize: int = 4,
              auditor=None) -> NetworkParams:
    """One-shot calibration on the collectives context ``coll``: measure
    the ladder (``CARD_SIZES`` on a card, ``DEFAULT_SIZES`` elsewhere,
    unless ``sizes`` is given) and fit.

    ``auditor`` (an ``obs.DriftAuditor``) receives the POST-FIT ladder
    residuals: each measured point joined against the fitted model's
    prediction, recorded as algorithm ``"dense_ladder"``, the
    calibrator's own quality signal."""
    if sizes is None:
        sizes = CARD_SIZES if coll.device.type == "cuda" else DEFAULT_SIZES
    meas = measure_allreduce_times(coll, sizes, repeats)
    net = fit_network_params([b for b, _ in meas], [t for _, t in meas],
                             p=coll.p, isize=isize)
    if auditor is not None:
        for payload_bytes, t in meas:
            n_elems = payload_bytes // isize
            auditor.record(
                "dense_ladder", f"calibrate@{payload_bytes}B",
                t_dense_allreduce(coll.p, n_elems, net), t,
                p=coll.p, n=n_elems, kind="calibration")
    return net
