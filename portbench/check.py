"""The numbers that decide ``correct`` for a training cell: the program's
first steps against the reference's, on the same weights, tokens and
rounding bits.

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: by the worst leaf, the gap between the norms of the first
  step's gradient as the optimizer gets it (the program's from its first
  moment after one step, m / (1 - beta1)), over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
* ``update_gap``: the same for the norm of each leaf's change over the
  steps, leaving out the leaves whose raw reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
* ``residual_gap``: the same for each EF bucket's residual norm on each
  rank after the first step: the gradient less its top k, so nearly all
  of the gradient and little of the pick (see PERF.md: where gradients
  are dense, which k of 512 a rank picks is a coin flip among near-equal
  entries under any rounding, and the gaps of the picked gradient's norms
  stop growing with the rounding);
* ``*_median``: the median leaf's gap in place of the worst leaf's.

A gap of norms, not the norm of a difference: top-k and QSGD pick
entries, and a pick that rounding moves to a neighbour changes which
entry moved, not by how much the leaf did."""
from __future__ import annotations

import math
import statistics

QUIET = 1e-3


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap over the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        base = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / base if base > 0 else (
            0.0 if prog[k] == 0 else math.inf)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def _moving(ref: dict) -> list:
    raw = ref["raw_norms"]
    med = statistics.median(raw.values())
    return [k for k in raw if raw[k] >= QUIET * med]


def numbers(prog: dict, ref: dict) -> dict:
    """{name: value} from the program's and the reference's readings
    ({losses, grad_norms, change_norms}; the reference's raw_norms). A
    cell's limits file names the ones it compares."""
    loss = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
               for a, b in zip(prog["losses"], ref["losses"]))
    grads = _gaps(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    changes = _gaps(prog["change_norms"], ref["change_norms"], _moving(ref))

    res_p = [x for b in prog["residual_norms"] for x in b]
    res_r = [x for b in ref["residual_norms"] for x in b]
    residual = _gaps(dict(enumerate(res_p)), dict(enumerate(res_r)),
                     range(len(res_r)))

    def median(d):
        return (math.inf if math.inf in d.values()
                else statistics.median(d.values()))

    return {"loss_gap": loss, "residual_gap": max(residual.values()),
            "residual_gap_median": median(residual),
            "grad_gap": max(grads.values()),
            "grad_gap_median": median(grads),
            "update_gap": max(changes.values()),
            "update_gap_median": median(changes)}


def verdict(values: dict, limits: dict) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)


def report(checks: dict) -> list:
    """One line a number: name, value, limit (``checks``: the result
    line's {name: {"value", "limit"}})."""
    return [f"{k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]


def details(prog: dict, ref: dict, top: int = 4) -> dict:
    """What the numbers are made of (for setting limits, not for the
    verdict): each step's loss gap and the worst leaves' gaps by name."""
    grads = _gaps(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    moving = _moving(ref)
    changes = _gaps(prog["change_norms"], ref["change_norms"], moving)
    worst = lambda d: [["/".join(k), v] for k, v in  # noqa: E731
                       sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    res = {(str(b), str(r)): (p, q) for b, (ps, qs) in enumerate(
        zip(prog["residual_norms"], ref["residual_norms"]))
        for r, (p, q) in enumerate(zip(ps, qs))}
    residual = _gaps({k: v[0] for k, v in res.items()},
                     {k: v[1] for k, v in res.items()}, res)
    return {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in
                               zip(prog["losses"], ref["losses"])],
            "grad_worst": worst(grads), "update_worst": worst(changes),
            "residual_worst (bucket/rank)": worst(residual),
            "quiet_leaves": ["/".join(k) for k in ref["raw_norms"]
                             if k not in moving]}
