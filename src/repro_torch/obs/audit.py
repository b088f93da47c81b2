"""Cost-model drift auditor: predicted vs measured, per algorithm (the
JAX package's ``repro.obs.audit``).

  DriftAuditor            joins (algorithm, predicted_s, measured_s)
                          samples and reports per-algorithm residual
                          stats: median measured/predicted ratio, mean
                          relative error, a ``flagged`` bit when the
                          ratio leaves the trust band
  audit_sync_plan         probes each distinct bucket signature of a
                          training SyncPlan with the standalone
                          ``make_sparse_allreduce`` on a collectives
                          context and joins against ``bucket_time``
  audit_serve_plan        the same join for a ServePlan's activation
                          exchange (``exchange_activation_spmd`` on a
                          stacked (p, T, d) tensor vs the stream/dense
                          cost entries)

Probes run the real collectives OUTSIDE the training loop (at run end),
so the audit adds no host wait to the pipelined hot path. On a card they
are timed with CUDA events. A probe that ``make_sparse_allreduce``
refuses to build (an algorithm or a size it does not take: ``ValueError``,
``NotImplementedError``) is recorded as an ``audit/bucket_probe_failed``
event, as the reference records every failure; anything that fails once
the probe is built (a kernel that refuses its inputs, does not build or
launch, a CUDA error) propagates, because swallowing it would hide the
device. Both probes need the network parameters they are joined
against (``net``): the port carries no default network, and a probe on
an unknown one raises.
"""
from __future__ import annotations

import numpy as np
import torch


class DriftAuditor:
    """Accumulates predicted-vs-measured samples; reports per algorithm.

    ``flag_ratio`` bounds the trust band: an algorithm whose median
    measured/predicted ratio falls outside [1/flag_ratio, flag_ratio]
    is flagged as drifted.
    """

    def __init__(self, flag_ratio: float = 3.0):
        if flag_ratio <= 1.0:
            raise ValueError("flag_ratio must be > 1")
        self.flag_ratio = float(flag_ratio)
        self.samples: list[dict] = []

    def record(self, algorithm: str, name: str, predicted_s: float,
               measured_s: float, **extra) -> None:
        self.samples.append({
            "algorithm": algorithm, "name": name,
            "predicted_s": float(predicted_s),
            "measured_s": float(measured_s), **extra,
        })

    def __len__(self) -> int:
        return len(self.samples)

    # -- joins -------------------------------------------------------------
    def per_algorithm(self) -> dict[str, dict]:
        by: dict[str, list[dict]] = {}
        for s in self.samples:
            by.setdefault(s["algorithm"], []).append(s)
        out = {}
        for alg, rows in sorted(by.items()):
            pred = np.asarray([r["predicted_s"] for r in rows])
            meas = np.asarray([r["measured_s"] for r in rows])
            ok = pred > 0
            ratio = np.where(ok, meas / np.where(ok, pred, 1.0), np.nan)
            med = float(np.nanmedian(ratio)) if ok.any() else float("nan")
            rel = np.abs(meas - pred) / np.where(ok, pred, 1.0)
            out[alg] = {
                "count": int(len(rows)),
                "predicted_total_s": float(pred.sum()),
                "measured_total_s": float(meas.sum()),
                "median_ratio": med,
                "mean_rel_err": float(np.nanmean(np.where(ok, rel, np.nan)))
                if ok.any() else float("nan"),
                "flagged": bool(np.isfinite(med) and not
                                (1.0 / self.flag_ratio <= med
                                 <= self.flag_ratio)),
            }
        return out

    def net_scale_hint(self) -> float | None:
        """Overall median measured/predicted ratio — the single scalar a
        calibrator can fold back into its fitted params (``None`` until
        at least one positive-prediction sample exists)."""
        r = [s["measured_s"] / s["predicted_s"] for s in self.samples
             if s["predicted_s"] > 0]
        return float(np.median(r)) if r else None

    def flagged_algorithms(self) -> list[str]:
        return [a for a, st in self.per_algorithm().items() if st["flagged"]]

    def report(self) -> dict:
        return {
            "kind": "drift_audit",
            "flag_ratio": self.flag_ratio,
            "samples": int(len(self.samples)),
            "net_scale_hint": self.net_scale_hint(),
            "per_algorithm": self.per_algorithm(),
            "flagged": self.flagged_algorithms(),
        }

    def emit(self, registry) -> None:
        """Mirror the per-algorithm join into the metrics registry as
        ``audit/algorithm_residual`` events (one per algorithm)."""
        for alg, st in self.per_algorithm().items():
            registry.event("audit/algorithm_residual", algorithm=alg, **st)
        hint = self.net_scale_hint()
        if hint is not None:
            registry.gauge("audit/net_scale_hint").set(hint)

    def summary(self) -> str:
        stats = self.per_algorithm()
        if not stats:
            return "  (no audit samples)"
        w = max(len(a) for a in stats)
        lines = [f"  {'algorithm':<{w}}  {'n':>3}  {'pred_ms':>9}  "
                 f"{'meas_ms':>9}  {'med_ratio':>9}  flag"]
        for alg, st in stats.items():
            lines.append(
                f"  {alg:<{w}}  {st['count']:>3}  "
                f"{st['predicted_total_s'] * 1e3:>9.3f}  "
                f"{st['measured_total_s'] * 1e3:>9.3f}  "
                f"{st['median_ratio']:>9.3f}  "
                f"{'DRIFT' if st['flagged'] else 'ok'}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Plan probes: time the real collectives, join against the cost model.
# ---------------------------------------------------------------------------

def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, args, reps: int, device: torch.device) -> float:
    """Best-of-reps time of one call in seconds (one warm-up call first),
    CUDA events on a card (``utils.calibrate.call_seconds``)."""
    from repro_torch.utils.calibrate import call_seconds

    fn(*args)
    _wait(device)
    return min(call_seconds(lambda: fn(*args), device)
               for _ in range(max(1, reps)))


def audit_sync_plan(plan, coll, *, net, reps: int = 3,
                    auditor: DriftAuditor | None = None, registry=None,
                    max_n: int = 1 << 22, seed: int = 0) -> DriftAuditor:
    """Probe each DISTINCT (algorithm, n, k) bucket signature of a
    training ``SyncPlan`` with the standalone sparse allreduce over the
    collectives context ``coll`` and record predicted (``bucket_time``
    under ``net``) vs measured into ``auditor``.

    One probe per signature, not per bucket: the same collective, the same
    cost entry. Buckets with n > ``max_n`` are skipped (probing them would
    dominate the run being audited). Each probe sums ``coll.local_ranks``
    normal vectors drawn from ``seed`` on ``coll.device``."""
    from repro_torch.core.allreduce import make_sparse_allreduce
    from repro_torch.core.cost_model import bucket_time

    auditor = auditor if auditor is not None else DriftAuditor()
    p = coll.p
    cfg = plan.cfg
    vb = cfg.qsgd_bits if cfg.qsgd_bits is not None else 32
    gen = np.random.default_rng(seed)

    seen: set[tuple] = set()
    for g in plan.groups:
        for b in g.buckets:
            k = plan.bucket_k(g, b)
            sig = (b.algorithm, b.n, k)
            if sig in seen:
                continue
            seen.add(sig)
            if b.n > max_n:
                if registry is not None:
                    registry.event("audit/bucket_skipped", name=b.name,
                                   n=b.n, reason=f"n > max_n={max_n}")
                continue
            predicted = bucket_time(b.algorithm, p, k, b.n, net, vb)
            x = torch.from_numpy(gen.standard_normal(
                (coll.local_ranks, b.n), dtype=np.float32)).to(coll.device)
            try:
                fn = make_sparse_allreduce(
                    coll, b.n, cfg.k_per_bucket, cfg.bucket_size,
                    algorithm=b.algorithm, impl=cfg.impl)
            except (ValueError, NotImplementedError) as e:
                if registry is not None:
                    registry.event("audit/bucket_probe_failed", name=b.name,
                                   algorithm=b.algorithm, error=str(e))
                continue
            # outside the try: a launch that fails (a kernel refusing its
            # inputs, a CUDA error) propagates
            measured = _time_fn(fn, (x, None), reps, coll.device)
            auditor.record(b.algorithm, b.name, predicted, measured,
                           n=b.n, k=k, p=p, kind="train_bucket")
    if registry is not None:
        auditor.emit(registry)
    return auditor


def audit_serve_plan(plan, *, net, device="cuda", reps: int = 3,
                     auditor: DriftAuditor | None = None, registry=None,
                     seed: int = 0) -> DriftAuditor:
    """Probe a ``ServePlan``'s activation exchange: time
    ``exchange_activation_spmd`` on a (p, T, d) stack of normal partials
    (p = ``plan.dp_total``, drawn from ``seed``) on ``device`` and join
    against the stream/dense cost entries (``bucket_time`` under
    ``net``)."""
    from repro_torch.comm.executor import exchange_activation_spmd
    from repro_torch.core.cost_model import bucket_time
    from repro_torch.device import resolve_device

    if net is None:
        raise ValueError(
            "audit_serve_plan: no network parameters; the port carries no "
            "default network (fit one with utils.calibrate)")
    device = resolve_device(device)
    auditor = auditor if auditor is not None else DriftAuditor()
    p = plan.dp_total
    gen = np.random.default_rng(seed)
    for b in plan.buckets:
        predicted = bucket_time(b.algorithm, p, b.d, b.n, net)
        x = torch.from_numpy(gen.standard_normal(
            (p, b.tokens, b.d), dtype=np.float32)).to(device)
        measured = _time_fn(lambda x, alg=b.algorithm:
                            exchange_activation_spmd(x, alg), (x,), reps,
                            device)
        auditor.record(b.algorithm, b.name, predicted, measured,
                       n=b.n, k=b.d, p=p, kind="serve_bucket")
    if registry is not None:
        auditor.emit(registry)
    return auditor
