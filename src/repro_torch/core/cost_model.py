"""Alpha-beta cost model for the SparCML collectives (paper §5.3).

Used for (a) trace-time algorithm auto-selection, (b) the Fig.-3 style
benchmark, (c) property tests of the paper's bound ordering and of the
Lemma 5.2 speedup cap.

The model is deliberately the paper's: T(L) = alpha + beta * L. It holds
no network constants: every function takes ``net`` explicitly, and
``NetworkParams`` has no default latency or bandwidth, because the values
belong to the interconnect the collectives run on: ``utils/calibrate.py``
fits them on the context a run uses (the reference's defaults describe
another machine). ``algorithm="auto"`` resolves through
:func:`select_algorithm` on parameters the caller passes: the plan
constructors and ``make_sparse_allreduce`` take ``net=``, and the Trainer
and the entry points fit it on their context first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

from .density import expected_nnz
from .sparse_stream import INDEX_BYTES, delta_threshold

# What algorithm="auto" raises with when no network parameters are given.
AUTO_NEEDS_NET = (
    "algorithm='auto' selects by the cost model and needs network "
    "parameters: pass net= (utils/calibrate.py fits them on a collectives "
    "context), or let the entry point (Trainer, run_lm, run_classify) "
    "calibrate")


@dataclass(frozen=True)
class NetworkParams:
    alpha: float                    # seconds per message/hop
    link_bytes_per_s: float         # per-link bandwidth
    isize: int = 4                  # bytes per value (fp32)

    @property
    def beta_d(self) -> float:
        """Seconds per dense value word."""
        return self.isize / self.link_bytes_per_s

    @property
    def beta_s(self) -> float:
        """Seconds per sparse (index,value) item. beta_s > beta_d (paper §5.2)."""
        return (self.isize + INDEX_BYTES) / self.link_bytes_per_s


def t_dense_allreduce(p: int, n: int, net: NetworkParams) -> float:
    """Rabenseifner (paper §5.3.2): 2 log2(P) alpha + 2 (P-1)/P N beta_d."""
    return 2 * math.log2(p) * net.alpha + 2 * (p - 1) / p * n * net.beta_d


def t_ssar_recursive_double(
    p: int, k: int, n: int, net: NetworkParams,
    expected: bool = True, reduced_nnz: float | None = None,
) -> tuple[float, float, float]:
    """(lower, expected, upper) for SSAR_Recursive_double.

    lower: full index overlap (k items per round);
    upper: zero overlap (2^t k items in round t, sums to (P-1)k);
    expected: per-round fill-in from the uniform model (App. B), or — when
    ``reduced_nnz`` (a MEASURED final fill-in, adaptive telemetry) is given
    — the uniform per-round curve rescaled so it lands on the measurement.
    """
    lat = math.log2(p) * net.alpha
    lo = lat + math.log2(p) * k * net.beta_s
    hi = lat + (p - 1) * k * net.beta_s
    scale = 1.0
    if reduced_nnz is not None:
        uniform_final = expected_nnz(k, n, p)
        if uniform_final > 0:
            scale = reduced_nnz / uniform_final
    # Round t carries at most 2^t * k items (zero overlap) and at most n;
    # the measured rescale must respect both, or 'expected' could exceed
    # its own upper bound and over-penalize this algorithm in selection.
    exp_items = sum(
        min(expected_nnz(k, n, 2**t) * scale, (2**t) * k, n)
        for t in range(int(math.log2(p)))
    )
    exp = lat + exp_items * net.beta_s
    return lo, exp, hi


def t_ssar_split_allgather(
    p: int, k: int, n: int, net: NetworkParams,
    reduced_nnz: float | None = None,
) -> tuple[float, float, float]:
    """(lower, expected, upper) for SSAR_Split_allgather (paper §5.3.2).

    Latency L2 = (P-1) alpha + log2(P) alpha (direct split sends + allgather).
    Bandwidth between 2 (P-1)/P k beta_s and P k beta_s. ``reduced_nnz``
    replaces the uniform-model expected reduced size with a measurement.
    """
    lat = (p - 1) * net.alpha + math.log2(p) * net.alpha
    lo = lat + 2 * (p - 1) / p * k * net.beta_s
    hi = lat + p * k * net.beta_s
    kk = (reduced_nnz if reduced_nnz is not None
          else expected_nnz(k, n, p))  # reduced size: measured or expected
    exp = lat + ((p - 1) / p * k + (p - 1) / p * kk) * net.beta_s
    return lo, exp, hi


def t_dsar_split_allgather(
    p: int, k: int, n: int, net: NetworkParams, value_bits: int = 32
) -> tuple[float, float]:
    """(lower, upper) for DSAR_Split_allgather (paper §5.3.3).

    Split phase sparse; second phase dense allgather of N/P-shards, whose
    word size can shrink by quantization (paper §6) to value_bits.
    """
    lat = (p - 1) * net.alpha + math.log2(p) * net.alpha
    beta_q = net.beta_d * value_bits / (8 * net.isize)
    lo = lat + (p - 1) / p * n * beta_q
    hi = lat + k * net.beta_s + (p - 1) / p * n * beta_q
    return lo, hi


# ---------------------------------------------------------------------------
# Near-optimal portfolio (DESIGN.md §9): capacity-clamped algorithms.
# Both bound the END representation to O(k) items per rank; entries past a
# clamp are never silently lost — the executor folds them into the owning
# bucket's EF residual (the "global residual" rule).
# ---------------------------------------------------------------------------

BALANCE_EPS = 0.25  # headroom of the balanced/rearranged capacity clamps


def balanced_shard_cap(k: int, p: int, n: Optional[int] = None,
                       eps: float = BALANCE_EPS) -> int:
    """Per-owner output capacity of ``ssar_balanced_split``: the balance
    pass re-top-k's each owned range down to ~(k/P)(1+eps) entries — the
    Ok-Top-k O(k) traffic bound. Never exceeds the owned range length."""
    cap = max(1, math.ceil(k / p * (1.0 + eps)))
    if n is not None:
        cap = min(cap, -(-n // p))
    return cap


def rearranged_round_caps(k: int, n: int, p: int,
                          eps: float = BALANCE_EPS) -> list[tuple[int, int]]:
    """(send_cap, merged_cap) per recursive-halving round of
    ``ssar_rearranged_rs``. Round 0 sends exactly k/2 items (bucket-
    uniform streams hold exactly half their entries in each half-range);
    round t >= 1 sends and keeps at most k(1+eps)/2^(t+1). Entries past
    a cap are the smallest-magnitude ones and fold into the EF residual,
    so total traffic stays O(k) without losing gradient mass."""
    caps = []
    for t in range(int(math.log2(p))):
        half = n >> (t + 1)
        merged = min(half, max(1, math.ceil(k * (1.0 + eps) / (1 << (t + 1)))))
        send = min(half, max(1, -(-k // 2))) if t == 0 else merged
        caps.append((send, merged))
    return caps


def t_ssar_balanced_split(
    p: int, k: int, n: int, net: NetworkParams,
    reduced_nnz: float | None = None,
) -> tuple[float, float, float]:
    """(lower, expected, upper) for ssar_balanced_split (Ok-Top-k style).

    Same latency shape as split_allgather ((P-1) direct split sends +
    log2(P) allgather rounds), but the gather phase ships each owner's
    re-top-k'd shard at the fixed (k/P)(1+eps) capacity instead of the
    O(kP) worst-case range union: total bandwidth <= k(2+eps) beta_s.
    ``reduced_nnz`` replaces the uniform-model reduced size, as in
    :func:`t_ssar_split_allgather`.
    """
    lat = (p - 1) * net.alpha + math.log2(p) * net.alpha
    cap = float(balanced_shard_cap(k, p, n))
    split = (p - 1) / p * k
    kk = (reduced_nnz if reduced_nnz is not None else expected_nnz(k, n, p))
    kk = min(max(kk, 0.0), float(p * k), float(n))
    lo = lat + (split + (p - 1) * min(k / p, cap)) * net.beta_s
    hi = lat + (split + (p - 1) * cap) * net.beta_s
    exp = lat + (split + (p - 1) * min(kk / p, cap)) * net.beta_s
    return lo, min(max(exp, lo), hi), hi


def t_ssar_rearranged_rs(
    p: int, k: int, n: int, net: NetworkParams,
    reduced_nnz: float | None = None,
) -> tuple[float, float, float]:
    """(lower, expected, upper) for ssar_rearranged_rs (SparDL style).

    log2(P) recursive-halving rounds in stream form (one ppermute each,
    no densify between phases) followed by a log2(P)-round allgather of
    the capacity-clamped owned shards: latency 2 log2(P) alpha — the
    Rabenseifner latency, (P-1)x below the split algorithms — and
    bandwidth <= ~2k(1+eps) beta_s. ``reduced_nnz`` rescales the
    per-round uniform fill-in curve as in t_ssar_recursive_double.
    """
    caps = rearranged_round_caps(k, n, p)
    lat = 2 * math.log2(p) * net.alpha
    scale = 1.0
    if reduced_nnz is not None:
        uniform_final = expected_nnz(k, n, p)
        if uniform_final > 0:
            scale = reduced_nnz / uniform_final
    rs_lo = rs_exp = rs_hi = 0.0
    for t, (send_cap, _) in enumerate(caps):
        # Entering round t the stream holds ~fill(2^t)/2^t entries of its
        # current range; it sends the half belonging to the partner.
        fill = min(expected_nnz(k, n, 2 ** t) * scale,
                   float((2 ** t) * k), float(n))
        rs_exp += min(fill / (1 << (t + 1)), float(send_cap))
        rs_lo += min(k / (1 << (t + 1)), float(send_cap))
        rs_hi += float(send_cap)
    final_cap = float(caps[-1][1] if caps else n)
    fill_p = min(expected_nnz(k, n, p) * scale, float(p * k), float(n))
    lo = lat + (rs_lo + (p - 1) * min(k / p, final_cap)) * net.beta_s
    hi = lat + (rs_hi + (p - 1) * final_cap) * net.beta_s
    exp = lat + (rs_exp + (p - 1) * min(fill_p / p, final_cap)) * net.beta_s
    return lo, min(max(exp, lo), hi), hi


def t_stream_allgather(p: int, cap_rows: int, d: int,
                       net: NetworkParams) -> float:
    """Row-stream all-gather: the serve-side activation exchange
    (DESIGN.md §8). Every rank broadcasts a fixed-capacity stream of
    ``cap_rows`` (row index, d-vector) items — one item per active token
    routed to a local expert — and receives the other P-1 streams."""
    row_bytes = d * net.isize + INDEX_BYTES
    return (math.log2(p) * net.alpha
            + (p - 1) * cap_rows * row_bytes / net.link_bytes_per_s)


def stream_wire_bytes(p: int, cap_rows: int, d: int, isize: int = 4) -> float:
    """Per-rank wire bytes of one row-stream all-gather step (receive
    side: P-1 foreign streams of cap_rows rows). The ONE accounting the
    serve executor's telemetry and the ServePlan selection rule share —
    they must never diverge (same contract as :func:`pod_wire_bytes`)."""
    if p <= 1:
        return 0.0
    return (p - 1) * cap_rows * float(d * isize + INDEX_BYTES)


def parse_stream_cap(algorithm: str) -> int:
    """Row capacity of a ``stream_gather@<cap>`` serve algorithm tag (the
    capacity is part of the plan signature, so it rides the string).

    Raises ValueError on malformed tags: the tag is checkpoint/user input
    (plan signatures, replan overrides), and the opaque ``int()`` crash it
    used to produce pointed at nothing."""
    head, sep, tail = algorithm.partition("@")
    if head != "stream_gather" or not sep:
        raise ValueError(
            f"malformed stream algorithm tag {algorithm!r}: "
            "expected 'stream_gather@<cap>'")
    try:
        cap = int(tail)
    except ValueError:
        raise ValueError(
            f"malformed stream algorithm tag {algorithm!r}: "
            f"capacity {tail!r} is not an integer") from None
    if cap <= 0:
        raise ValueError(
            f"malformed stream algorithm tag {algorithm!r}: "
            f"capacity must be positive, got {cap}")
    return cap


def dsar_speedup_cap(n: int, isize: int = 4) -> float:
    """Lemma 5.2: once the result is dense, sparsity alone buys at most
    2/kappa versus a bandwidth-optimal dense allreduce, kappa = delta/N."""
    kappa = delta_threshold(n, isize) / n
    return 2.0 / kappa


# ---------------------------------------------------------------------------
# Algorithm registry: the ONE place an algorithm declares its modeled cost
# and wire accounting. select_algorithm / bucket_time / bucket_wire_bytes
# all dispatch through it, so adding an algorithm is one registration —
# the chain of hand-written if/elif dispatches is gone.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AlgorithmEntry:
    """One registered allreduce algorithm.

    cost_fn(p, k, n, net, value_bits, reduced_nnz) -> expected seconds;
    wire_fn(p, k, n, nnz, value_bits, isize) -> per-rank bytes per step
    (pure arithmetic in ``nnz`` — it may be a traced telemetry scalar);
    sparse_result: the end-representation grows with fill-in, so the
    delta switchover (paper §5.3.3) rules it out once E[K] >= delta;
    output_cap_fn(p, k, n) -> post-reduction nnz bound of a capacity-
    clamped algorithm (None = unclamped). A clamped algorithm whose
    bound stays under delta SURVIVES the switchover: its result cannot
    densify past the bound, whatever the measured fill-in.

    scatter_cost_fn / scatter_wire_fn (same signatures): the SCATTERED
    output mode (DESIGN.md §11) — the algorithm terminates at the owner
    shard instead of re-replicating, dropping its gather/allgather
    phase. None = not scatter-capable: the executor computes the
    replicated result and slices, so the replicated charge stands."""

    cost_fn: Callable
    wire_fn: Callable
    sparse_result: bool = False
    output_cap_fn: Optional[Callable] = None
    scatter_cost_fn: Optional[Callable] = None
    scatter_wire_fn: Optional[Callable] = None

    @property
    def scatter_capable(self) -> bool:
        return self.scatter_wire_fn is not None


def _clamped_nnz(nnz, cap: float):
    """Clamp a host-side nnz at an algorithm's output capacity. A traced
    telemetry nnz is measured POST-clamp (count_nonzero of the clamped
    result), so it already respects the cap and passes through."""
    if isinstance(nnz, (int, float)):
        return min(float(nnz), float(cap))
    return nnz


def _cost_ssar_recursive_double(p, k, n, net, value_bits, reduced_nnz):
    return t_ssar_recursive_double(p, k, n, net, reduced_nnz=reduced_nnz)[1]


def _cost_ssar_split_allgather(p, k, n, net, value_bits, reduced_nnz):
    return t_ssar_split_allgather(p, k, n, net, reduced_nnz=reduced_nnz)[1]


def _cost_dsar_split_allgather(p, k, n, net, value_bits, reduced_nnz):
    return sum(t_dsar_split_allgather(p, k, n, net, value_bits)) / 2


def _cost_dense(p, k, n, net, value_bits, reduced_nnz):
    return t_dense_allreduce(p, n, net)


def _cost_ssar_balanced_split(p, k, n, net, value_bits, reduced_nnz):
    return t_ssar_balanced_split(p, k, n, net, reduced_nnz=reduced_nnz)[1]


def _cost_ssar_rearranged_rs(p, k, n, net, value_bits, reduced_nnz):
    return t_ssar_rearranged_rs(p, k, n, net, reduced_nnz=reduced_nnz)[1]


def _wire_dense(p, k, n, nnz, value_bits, isize):
    # compressed-dense end-representation OR raw psum: one dense
    # allreduce of the n-vector (Rabenseifner accounting).
    return 2 * (p - 1) / p * n * isize


def _wire_ssar_recursive_double(p, k, n, nnz, value_bits, isize):
    # log2(P) rounds; round t carries ~fill-in-many items. Charged at
    # the measured final fill per round (upper-bounds early rounds).
    return math.log2(p) * nnz * (isize + INDEX_BYTES)


def _wire_ssar_split_allgather(p, k, n, nnz, value_bits, isize):
    item = isize + INDEX_BYTES
    return (p - 1) / p * k * item + (p - 1) / p * nnz * item


def _wire_dsar_split_allgather(p, k, n, nnz, value_bits, isize):
    # value_bits < 32 also adds one fp32 scale per QSGD bucket; the
    # exact figure lives in plan.wire_bytes — telemetry keeps the
    # dominant terms only.
    item = isize + INDEX_BYTES
    return (p - 1) / p * k * item + (p - 1) / p * n * value_bits / 8


def _wire_ssar_balanced_split(p, k, n, nnz, value_bits, isize):
    # split phase as split_allgather; the gather phase is bounded by the
    # per-owner re-top-k capacity — the O(k) bound that is the point.
    item = isize + INDEX_BYTES
    cap_total = p * balanced_shard_cap(k, p, n)
    return ((p - 1) / p * k
            + (p - 1) / p * _clamped_nnz(nnz, cap_total)) * item


def _wire_ssar_rearranged_rs(p, k, n, nnz, value_bits, isize):
    # reduce-scatter rounds ship at most send_cap items each (static
    # caps); the allgather ships the measured (clamped) union.
    item = isize + INDEX_BYTES
    caps = rearranged_round_caps(k, n, p)
    final_cap = caps[-1][1] if caps else n
    rs = float(sum(send for send, _ in caps))
    return (rs + (p - 1) / p * _clamped_nnz(nnz, p * final_cap)) * item


def _balanced_output_cap(p, k, n):
    return p * balanced_shard_cap(k, p, n)


def _rearranged_output_cap(p, k, n):
    caps = rearranged_round_caps(k, n, p)
    return p * (caps[-1][1] if caps else n)


# -- scattered variants (DESIGN.md §11): stop at the owner shard ----------
#
# Each drops exactly its gather/allgather phase from the replicated
# accounting above; the split/reduce-scatter phase is unchanged. The
# dense param allgather that replaces the dropped phase is charged
# separately (t_param_allgather) — it is algorithm-independent and
# overlappable with the next step's forward, so folding it in here would
# make every scattered candidate look identical at the margin.

def _scost_dense(p, k, n, net, value_bits, reduced_nnz):
    # reduce-scatter half of Rabenseifner: log2(P) alpha + (P-1)/P N beta_d
    return math.log2(p) * net.alpha + (p - 1) / p * n * net.beta_d


def _scost_dsar_split_allgather(p, k, n, net, value_bits, reduced_nnz):
    # split phase only; the quantized dense gather disappears entirely
    return (p - 1) * net.alpha + (p - 1) / p * k * net.beta_s


def _scost_ssar_balanced_split(p, k, n, net, value_bits, reduced_nnz):
    # direct split sends, no allgather rounds (the re-top-k'd shard is
    # the OUTPUT now, not a wire representation)
    return (p - 1) * net.alpha + (p - 1) / p * k * net.beta_s


def _scost_ssar_rearranged_rs(p, k, n, net, value_bits, reduced_nnz):
    # the log2(P) recursive-halving rounds, expected fill as in
    # t_ssar_rearranged_rs; the capped-shard allgather disappears
    caps = rearranged_round_caps(k, n, p)
    scale = 1.0
    if reduced_nnz is not None:
        uniform_final = expected_nnz(k, n, p)
        if uniform_final > 0:
            scale = reduced_nnz / uniform_final
    rs_exp = 0.0
    for t, (send_cap, _) in enumerate(caps):
        fill = min(expected_nnz(k, n, 2 ** t) * scale,
                   float((2 ** t) * k), float(n))
        rs_exp += min(fill / (1 << (t + 1)), float(send_cap))
    return math.log2(p) * net.alpha + rs_exp * net.beta_s


def _swire_dense(p, k, n, nnz, value_bits, isize):
    return (p - 1) / p * n * isize


def _swire_dsar_split_allgather(p, k, n, nnz, value_bits, isize):
    return (p - 1) / p * k * (isize + INDEX_BYTES)


def _swire_ssar_balanced_split(p, k, n, nnz, value_bits, isize):
    return (p - 1) / p * k * (isize + INDEX_BYTES)


def _swire_ssar_rearranged_rs(p, k, n, nnz, value_bits, isize):
    caps = rearranged_round_caps(k, n, p)
    return float(sum(send for send, _ in caps)) * (isize + INDEX_BYTES)


def t_param_allgather(p: int, n: int, net: NetworkParams) -> float:
    """The dense updated-param allgather scattered mode pays per bucket:
    log2(P) rounds shipping (P-1)/P N fp32 words per rank. Overlappable
    with the NEXT step's forward (DESIGN.md §11) — the adaptive
    controller weighs it by its expected exposed fraction, not at par."""
    return math.log2(p) * net.alpha + (p - 1) / p * n * net.beta_d


ALGORITHM_REGISTRY: dict[str, AlgorithmEntry] = {
    "ssar_recursive_double": AlgorithmEntry(
        _cost_ssar_recursive_double, _wire_ssar_recursive_double,
        sparse_result=True),
    "ssar_split_allgather": AlgorithmEntry(
        _cost_ssar_split_allgather, _wire_ssar_split_allgather,
        sparse_result=True),
    "dsar_split_allgather": AlgorithmEntry(
        _cost_dsar_split_allgather, _wire_dsar_split_allgather,
        scatter_cost_fn=_scost_dsar_split_allgather,
        scatter_wire_fn=_swire_dsar_split_allgather),
    "dense": AlgorithmEntry(
        _cost_dense, _wire_dense,
        scatter_cost_fn=_scost_dense, scatter_wire_fn=_swire_dense),
    "ssar_balanced_split": AlgorithmEntry(
        _cost_ssar_balanced_split, _wire_ssar_balanced_split,
        sparse_result=True, output_cap_fn=_balanced_output_cap,
        scatter_cost_fn=_scost_ssar_balanced_split,
        scatter_wire_fn=_swire_ssar_balanced_split),
    "ssar_rearranged_rs": AlgorithmEntry(
        _cost_ssar_rearranged_rs, _wire_ssar_rearranged_rs,
        sparse_result=True, output_cap_fn=_rearranged_output_cap,
        scatter_cost_fn=_scost_ssar_rearranged_rs,
        scatter_wire_fn=_swire_ssar_rearranged_rs),
}

ALL_ALGORITHMS = tuple(ALGORITHM_REGISTRY)


def algorithm_output_cap(algorithm: str, p: int, k: int, n: int):
    """Post-reduction nnz bound of a capacity-clamped algorithm (None
    for unclamped ones): the quantity the delta switchover compares to
    delta, both in :func:`select_algorithm` and in the adaptive
    controller's forced-switch rule."""
    entry = ALGORITHM_REGISTRY.get(algorithm)
    if entry is None or entry.output_cap_fn is None:
        return None
    return int(entry.output_cap_fn(p, k, n))


def select_algorithm(
    p: int,
    k: int,
    n: int,
    net: NetworkParams,
    value_bits: int = 32,
    allow: tuple = ALL_ALGORITHMS,
    reduced_nnz: float | None = None,
    scattered: bool = False,
) -> str:
    """THE auto-selection entry point: pick the cheapest registered
    algorithm by expected alpha-beta cost (paper §5.3, DESIGN.md §3.3).
    ``k`` is the per-rank selected item count, ``n`` the vector's
    canonical length.

    Mirrors the paper's guidance: recursive doubling for small data
    (latency-bound), split_allgather for large sparse results, DSAR once
    the result exceeds the delta threshold — plus the capacity-clamped
    portfolio (DESIGN.md §9), which survives the delta switchover as
    long as its clamped output bound stays under delta. ``allow``
    restricts the candidate set — the batched (model-sharded rows)
    pipeline only implements DSAR/dense, and the fusion planner passes
    that in.

    ``reduced_nnz`` closes the loop (DESIGN.md §7): a MEASURED
    post-reduction nnz (adaptive telemetry) replaces the uniform-model
    ``expected_nnz`` everywhere — both in the sparse-vs-dense delta
    decision and in the gather-phase cost terms — so fill-in growth and
    EF-residual densification feed back into the choice.

    ``scattered`` costs each candidate under the scattered output mode
    (DESIGN.md §11): scatter-capable algorithms drop their gather phase;
    the rest keep the replicated charge (the executor computes the full
    result and slices). The delta-switchover filter is unchanged — the
    reduce-scatter rounds still densify with fill-in.
    """
    delta = delta_threshold(n, net.isize)
    exp_k = (reduced_nnz if reduced_nnz is not None
             else expected_nnz(k, n, p))
    fill_dense = exp_k >= delta
    candidates = {}
    for name, entry in ALGORITHM_REGISTRY.items():
        if name not in allow:
            continue
        if name == "dense":
            # dense competes only past the switchover: below it, the
            # compressed-stream paths always model cheaper.
            if not fill_dense:
                continue
        elif entry.sparse_result and fill_dense:
            # Sparse end-representation no longer pays (paper §5.3.3) —
            # EXCEPT capacity-clamped algorithms whose output bound
            # stays under delta: their result cannot densify.
            cap = (entry.output_cap_fn(p, k, n)
                   if entry.output_cap_fn is not None else None)
            if cap is None or cap >= delta:
                continue
        cost_fn = (entry.scatter_cost_fn
                   if scattered and entry.scatter_cost_fn is not None
                   else entry.cost_fn)
        candidates[name] = cost_fn(p, k, n, net, value_bits, reduced_nnz)
    if not candidates:  # everything filtered: dense always works
        return "dense"
    return min(candidates, key=candidates.get)


def select_bucket_algorithm(
    p: int,
    k: int,
    n: int,
    net: NetworkParams,
    value_bits: int = 32,
    allow: tuple = ALL_ALGORITHMS,
    reduced_nnz: float | None = None,
    scattered: bool = False,
) -> str:
    """Per-fusion-bucket view of :func:`select_algorithm` (``k`` = the
    bucket's TOTAL selected items: rows x buckets-per-row x k_per_bucket,
    ``n`` its total canonical length). Thin wrapper — the one selection
    implementation lives in :func:`select_algorithm`."""
    return select_algorithm(p, k, n, net, value_bits, allow, reduced_nnz,
                            scattered)


# ---------------------------------------------------------------------------
# Overlap-aware step costing (non-blocking runtime, DESIGN.md §6)
# ---------------------------------------------------------------------------

def bucket_time(algorithm: str, p: int, k: int, n: int,
                net: NetworkParams, value_bits: int = 32,
                reduced_nnz: float | None = None,
                scattered: bool = False) -> float:
    """Expected collective time of ONE fusion bucket under its resolved
    algorithm (the per-bucket term the overlap model hides or exposes).
    ``reduced_nnz`` substitutes a measured post-reduction fill-in for the
    uniform model, exactly as in :func:`select_algorithm`.

    Serve-side activation buckets (DESIGN.md §8) use the
    ``stream_gather@<cap>`` algorithm family, where ``k`` is the ROW
    width (d) and the row capacity rides the tag: the cost is capacity-
    bound, not nnz-bound, because the stream ships at fixed cap."""
    if algorithm.startswith("stream_gather"):
        return t_stream_allgather(p, parse_stream_cap(algorithm), k, net)
    entry = ALGORITHM_REGISTRY.get(algorithm)
    if entry is None:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if scattered and entry.scatter_cost_fn is not None:
        return entry.scatter_cost_fn(p, k, n, net, value_bits, reduced_nnz)
    return entry.cost_fn(p, k, n, net, value_bits, reduced_nnz)


def bucket_wire_bytes(algorithm: str, p: int, k: int, n: int,
                      nnz=None, value_bits: int = 32, isize: int = 4,
                      scattered: bool = False):
    """Per-rank data-axis wire bytes of one bucket for one step. Pure
    arithmetic in ``nnz`` (a traced scalar inside the telemetry emitter,
    or a float on the host), so the executor can report measured wire
    volume in-graph. ``nnz`` defaults to the worst case (p*k).
    ``scattered`` charges the scatter variant where one exists (the
    gather phase drops); non-capable algorithms keep the replicated
    charge — the executor really does run them replicated and slice."""
    if algorithm.startswith("stream_gather"):
        # serve activation exchange: capacity-bound, k is the row width
        return stream_wire_bytes(p, parse_stream_cap(algorithm), k, isize)
    entry = ALGORITHM_REGISTRY.get(algorithm)
    if entry is None:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if nnz is None:
        nnz = float(min(n, p * k))
    if scattered and entry.scatter_wire_fn is not None:
        return entry.scatter_wire_fn(p, k, n, nnz, value_bits, isize)
    return entry.wire_fn(p, k, n, nnz, value_bits, isize)


def pod_wire_bytes(p_pod: int, n: int, cap: int,
                   pod_sparse: bool = False, isize: int = 4) -> float:
    """Per-rank CROSS-POD wire bytes of one bucket: the dense psum
    (Rabenseifner accounting) or the sparse (idx,val) stream exchange of
    ``pod_sparse`` buckets at stream capacity ``cap`` (DESIGN.md §7.2).
    The ONE accounting both the executor's telemetry and the adaptive
    controller's demotion rule use — they must never diverge."""
    if p_pod <= 1:
        return 0.0
    if pod_sparse:
        return p_pod * cap * float(isize + INDEX_BYTES)
    return 2.0 * (p_pod - 1) / p_pod * n * isize


def plan_bucket_times(plan, p: Optional[int], net: NetworkParams,
                      densities: dict | None = None) -> list[float]:
    """Expected per-bucket collective times for a comm ``SyncPlan`` (duck-
    typed, so this module needs nothing of the comm package), in plan
    order: the drain sequence the pipelined superstep overlaps with
    compute. ``p`` None means the plan's ``dp_total``. ``densities`` maps
    bucket name -> measured post-reduction nnz (the adaptive telemetry
    window), overriding the uniform fill-in model."""
    p = p or plan.dp_total
    cfg = plan.cfg
    vb = cfg.qsgd_bits if cfg.qsgd_bits is not None else 32
    scattered = bool(getattr(plan, "scattered", False))
    out = []
    for g in plan.groups:
        for b in g.buckets:
            k = plan.bucket_k(g, b)
            nnz = None if densities is None else densities.get(b.name)
            out.append(bucket_time(b.algorithm, p, k, b.n, net, vb,
                                   reduced_nnz=nnz, scattered=scattered))
    return out


def exposed_bucket_times(t_buckets, t_overlap: float) -> list[float]:
    """Per-bucket EXPOSED comm time when the buckets drain back-to-back
    under ``t_overlap`` seconds of independent compute (the next step's
    forward/backward): a bucket fully hidden under compute costs 0, the
    bucket straddling the compute edge costs only its uncovered tail,
    every later bucket is fully exposed."""
    out, cum = [], 0.0
    for t in t_buckets:
        hidden = min(t, max(0.0, t_overlap - cum))
        out.append(t - hidden)
        cum += t
    return out


def t_step_overlapped(t_compute: float, t_buckets,
                      staleness: int = 1) -> float:
    """Modeled steady-state per-step time of the pipelined runtime.

    staleness=0 serializes compute with the whole bucket drain (the
    synchronous step); staleness>=1 runs the previous step's drain under
    this step's compute, paying only the exposed fraction — equivalently
    max(t_compute, sum(t_buckets)). Pipelined is never slower in this
    model: the exposed sum is <= the full drain."""
    if staleness == 0:
        return t_compute + sum(t_buckets)
    return t_compute + sum(exposed_bucket_times(t_buckets, t_compute))
