"""Deterministic chaos-injection harness + recovery policy (the JAX
package's ``repro.runtime.faults``, DESIGN.md §12).

SparCML's premise is that the collective is the bottleneck; its twin at
scale is *failure*. This module is the sense half's counterpart to the
obs layer's act half: a seedable :class:`FaultPlan` describes WHICH
fault classes fire at WHICH steps (or decode ticks), and a
:class:`FaultInjector` is the stateful host-side hook box the runtime
loops call at their natural boundaries. Everything is deterministic —
two runs with the same plan inject byte-identically — and every spec is
one-shot-per-repeat: after a rewind the replayed steps run CLEAN, which
is what makes recovery bit-reproducible against an uninjected run.

Fault classes (``FAULT_CLASSES``), with their injection points:

  nonfinite     NaN/Inf written into selected gradient leaves IN-GRAPH:
                the injector rides a ``__fault__`` vector inside the
                batch dict (``FAULT_KEY``; one f32 per grad leaf, 0 =
                clean, 1 = NaN, 2 = Inf) that the guarded pipelined step
                built with ``inject=True`` consumes (runtime/pipeline.py)
                on the device. Selected leaves select the fusion buckets
                they land in.
  straggler     multiplicative retire delay (``factor`` x the current
                rolling median step time, floor ``duration_s``) charged
                to one emulated rank's retire — trips the driver's
                watchdog, never the math.
  stall         the data-pipeline batch_fn blocks for ``duration_s``
                inside the prefetch thread (drives the bounded
                ``queue.get`` timeout / dead-thread propagation path).
  collective    a raised exception at the collective layer boundary
                (pre-dispatch, so state is never half-consumed). A CUDA
                error of the step itself classifies here too (unknown
                failures draw on the generic budget): a sticky one
                poisons the context, every retry fails the same way, and
                the run ends as RetryBudgetExhausted after its budget.
  ckpt_corrupt  bytes flipped in the just-written checkpoint's
                arrays.npz — caught by the CRC verification on the next
                restore, which falls back to the newest VALID step.
  sigterm       SIGTERM delivered to the process mid-superstep; the
                flight recorder's signal handler dumps the blackbox and
                chains to the previous handler.

The recovery half (:class:`RecoveryConfig` + :class:`RetrySupervisor`)
is what ``runtime.driver.run_pipelined`` consults on every failure: a
bounded exponential-backoff retry loop with deterministic jittered
delays and PER-FAULT-CLASS retry budgets; exhausting a budget escalates
to a clean abort (:class:`RetryBudgetExhausted`) after the blackbox
dump. Classification is by exception type (``classify_fault``).
"""
from __future__ import annotations

import os
import signal
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

# Reserved batch-dict key carrying the per-grad-leaf injection vector
# (f32 (n_leaves,): 0 clean / 1 NaN / 2 Inf). Batch keys are data-field
# names ("tokens", "labels", ...), so the dunder cannot collide.
FAULT_KEY = "__fault__"

FAULT_CLASSES = ("nonfinite", "straggler", "stall", "collective",
                 "ckpt_corrupt", "sigterm")


# --------------------------------------------------------------------------
# Exceptions — the fault-class taxonomy the supervisor classifies by type
# --------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base of every fault-runtime exception."""


class FaultInjectionError(FaultError):
    """An injected collective-layer failure (the 'collective' class)."""


class NonFiniteEscalation(FaultError):
    """The guarded step tripped ``max_consecutive_nonfinite`` times in a
    row — skip-recovery is no longer converging; rewind to the last-good
    checkpoint."""


class PrefetchStalled(FaultError):
    """The background prefetch thread died or stopped producing within
    the bounded ``queue.get`` timeout. ``cause`` carries the thread's
    own exception when one was captured."""

    def __init__(self, msg: str, cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.cause = cause


class RetryBudgetExhausted(FaultError):
    """A fault class used up its retry budget: clean abort."""


def classify_fault(exc: BaseException) -> str:
    """Map an exception to the retry-budget class it draws from."""
    if isinstance(exc, NonFiniteEscalation):
        return "nonfinite"
    if isinstance(exc, PrefetchStalled):
        return "stall"
    if type(exc).__name__ == "CheckpointCorrupt" or \
            isinstance(exc, (OSError, EOFError)):
        return "ckpt_corrupt"
    if isinstance(exc, FaultInjectionError):
        return "collective"
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return "sigterm"
    return "collective"  # unknown failures retry on the generic budget


# --------------------------------------------------------------------------
# Fault plans
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``step`` is a global training step for the
    driver hooks, a decode tick for the serve hooks. ``repeat`` fires the
    same fault on that many consecutive steps (consecutive-trip tests).
    ``leaves`` selects grad-leaf indices for nonfinite injection (None =
    every leaf; leaves select the fusion buckets they land in)."""

    kind: str
    step: int
    mode: str = "nan"               # nonfinite: "nan" | "inf"
    leaves: Optional[tuple] = None  # nonfinite: grad-leaf indices
    factor: float = 4.0             # straggler: x rolling median
    duration_s: float = 0.0         # straggler floor / stall block time
    rank: int = 0                   # straggler: emulated rank charged
    repeat: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_CLASSES:
            raise ValueError(
                f"kind must be one of {FAULT_CLASSES}: {self.kind!r}")
        if self.mode not in ("nan", "inf"):
            raise ValueError(f"mode must be nan|inf: {self.mode!r}")
        if self.repeat < 1:
            raise ValueError(f"repeat must be >= 1: {self.repeat}")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of :class:`FaultSpec` rows plus the seed
    that derives any randomized choices. ``FaultPlan(())`` is the clean
    plan — an injector over it is a no-op whose hooks still execute, so
    A/B runs share the exact host code path."""

    specs: tuple = ()
    seed: int = 0

    @staticmethod
    def single(kind: str, step: int, **kw) -> "FaultPlan":
        return FaultPlan(specs=(FaultSpec(kind=kind, step=step, **kw),))

    @staticmethod
    def chaos(seed: int, num_steps: int,
              classes: tuple = ("nonfinite", "straggler", "stall",
                                "collective"),
              ckpt_every: Optional[int] = None) -> "FaultPlan":
        """Deterministic random plan: one fault per class, each at a
        seed-derived step inside [warmup, num_steps). Only RECOVERABLE
        classes by default — the chaos-smoke CI job asserts the run
        completes. ``ckpt_every`` adds a ckpt_corrupt + collective pair
        (corrupt a save, then force the restore that must fall back)."""
        rng = np.random.default_rng(seed)
        lo = max(2, num_steps // 8)
        hi = max(lo + 1, num_steps - 2)
        specs = [FaultSpec(kind=k, step=int(rng.integers(lo, hi)),
                           duration_s=0.2 if k in ("straggler", "stall")
                           else 0.0)
                 for k in classes]
        if ckpt_every and num_steps > 2 * ckpt_every:
            c = int(rng.integers(1, num_steps // ckpt_every))
            specs.append(FaultSpec(kind="ckpt_corrupt",
                                   step=c * ckpt_every))
            specs.append(FaultSpec(kind="collective",
                                   step=min(num_steps - 2,
                                            c * ckpt_every + 1)))
        return FaultPlan(specs=tuple(specs), seed=seed)

    def by_kind(self, kind: str) -> tuple:
        return tuple(s for s in self.specs if s.kind == kind)


# --------------------------------------------------------------------------
# The injector — stateful hook box the runtime loops call
# --------------------------------------------------------------------------

class FaultInjector:
    """Executes a :class:`FaultPlan` against the runtime's host hooks.

    One-shot bookkeeping lives HERE (not in the immutable plan): each
    spec fires at most ``repeat`` times across the injector's lifetime,
    so a rewind replays the faulted steps clean — the property every
    bit-equal recovery test leans on. Hooks are thread-compatible (the
    stall hook runs inside the prefetch thread).

    ``bind`` attaches what the constructor cannot know: the number of
    gradient leaves (for the ``FAULT_KEY`` vector) and the metrics
    registry that counts fired faults (``faults/injected_<kind>``)."""

    def __init__(self, plan: FaultPlan, *, n_leaves: Optional[int] = None,
                 registry=None):
        self.plan = plan
        self.n_leaves = n_leaves
        self.registry = registry
        self._fired: dict[int, int] = {}   # spec index -> times fired
        self.log: list[tuple] = []         # (kind, step) audit trail

    def bind(self, *, n_leaves: Optional[int] = None,
             registry=None) -> "FaultInjector":
        if n_leaves is not None:
            self.n_leaves = int(n_leaves)
        if registry is not None:
            self.registry = registry
        return self

    # -- firing bookkeeping ------------------------------------------------
    def _take(self, kind: str, step: int) -> Optional[FaultSpec]:
        """The spec of ``kind`` scheduled at ``step`` if it still has
        unfired repeats, consuming one; else None. A spec with repeat=r
        covers steps [spec.step, spec.step + r)."""
        for i, s in enumerate(self.plan.specs):
            if s.kind != kind or not (s.step <= step < s.step + s.repeat):
                continue
            if self._fired.get(i, 0) >= s.repeat:
                continue
            self._fired[i] = self._fired.get(i, 0) + 1
            self.log.append((kind, step))
            if self.registry is not None:
                self.registry.counter(f"faults/injected_{kind}").inc()
                # field named "fault", not "kind": the JSONL sink writes
                # event rows as {"kind": "event", **fields} and a "kind"
                # field would clobber the row discriminator
                self.registry.event("faults/injected", fault=kind, step=step)
            return s
        return None

    @property
    def fired_total(self) -> int:
        return sum(self._fired.values())

    # -- training-driver hooks ---------------------------------------------
    def grad_flag(self, step: int) -> np.ndarray:
        """(n_leaves,) f32 injection vector for this step's batch
        (FAULT_KEY leaf): 0 clean, 1 NaN, 2 Inf per grad leaf."""
        if self.n_leaves is None:
            raise RuntimeError(
                "FaultInjector.bind(n_leaves=...) before grad_flag — the "
                "trainer knows the grad-leaf count, the plan does not")
        vec = np.zeros((self.n_leaves,), np.float32)
        spec = self._take("nonfinite", step)
        if spec is not None:
            val = 1.0 if spec.mode == "nan" else 2.0
            idx = (list(range(self.n_leaves)) if spec.leaves is None
                   else [i for i in spec.leaves if i < self.n_leaves])
            vec[idx] = val
        return vec

    def wrap_batch_fn(self, batch_fn: Callable[[int], dict],
                      inject_key: bool = True) -> Callable[[int], dict]:
        """Wrap the driver's ``batch_fn`` with the stall hook and (when
        ``inject_key``) the FAULT_KEY vector the guarded step consumes.
        Runs on the prefetch thread — sleeps there model a stalled data
        pipeline without touching the dispatch loop."""

        def wrapped(step: int) -> dict:
            stall = self._take("stall", step)
            if stall is not None and stall.duration_s > 0:
                time.sleep(stall.duration_s)
            batch = dict(batch_fn(step))
            if inject_key:
                batch[FAULT_KEY] = self.grad_flag(step)
            return batch

        return wrapped

    def before_dispatch(self, step: int, n_steps: int = 1) -> None:
        """Pre-dispatch hook: collective-layer raise and SIGTERM. The
        unit being dispatched covers steps [step, step + n_steps) — a
        K-step superstep dispatches once for K steps, and a spec
        scheduled anywhere inside the unit must still fire. Raised
        BEFORE the step is called, so no state is half-consumed and a
        restore/retry replays the unit exactly."""
        for s in range(step, step + max(1, n_steps)):
            if self._take("collective", s) is not None:
                raise FaultInjectionError(
                    f"injected collective failure at step {s}")
            if self._take("sigterm", s) is not None:
                os.kill(os.getpid(), signal.SIGTERM)

    def refund_undispatched(self, frontier: int) -> int:
        """Rewind-side bookkeeping for batch-carried injections. A
        nonfinite spec is CONSUMED when the prefetch thread produces the
        poisoned batch, but its effect only lands when a step consumes
        that batch — and a driver restore throws the prefetch queue
        away. Poison produced for steps at or beyond the dispatch
        frontier (the failure point's next-dispatch step) never reached
        the model, so those repeats are refunded and re-fire when the
        restarted prefetcher reproduces them. Steps BELOW the frontier
        were dispatched: they stay spent, replays run clean (the
        bit-equal contract). Only nonfinite refunds — a stall's side
        effect (the sleep) happens at production time, so it genuinely
        fired. Returns the number of refunded repeats."""
        refunded = 0
        for i, s in enumerate(self.plan.specs):
            if s.kind != "nonfinite":
                continue
            f = self._fired.get(i, 0)
            # fired repeats cover [s.step, s.step + f) in step order;
            # the tail at steps >= frontier was produced but never used
            lost = max(0, s.step + f - max(s.step, int(frontier)))
            if lost:
                self._fired[i] = f - lost
                refunded += lost
        if refunded and self.registry is not None:
            self.registry.counter("faults/refunded").inc(refunded)
            self.registry.event("faults/refunded", n=refunded,
                                frontier=int(frontier))
        return refunded

    def after_retire(self, first_step: int, n_steps: int,
                     median_s: float) -> None:
        """Straggler hook: a retire interval covering the spec'd step
        blocks for ``factor`` x the current rolling median (floor
        ``duration_s``) — the chosen rank's retire arrives late."""
        for s in range(first_step, first_step + n_steps):
            spec = self._take("straggler", s)
            if spec is not None:
                time.sleep(max(spec.duration_s,
                               spec.factor * max(median_s, 0.0)))

    def corrupt_checkpoint(self, directory: str, step: int,
                           write: bool = True) -> Optional[str]:
        """Post-save hook: when a ckpt_corrupt spec covers ``step``, flip
        bytes mid-file in the newest checkpoint's arrays.npz (the torn
        write a crashed/buggy writer leaves). Returns the corrupted path
        or None. ``write=False`` counts the fault without touching the
        file: every process of a process group calls the hook, the one
        that wrote the checkpoint corrupts it."""
        if self._take("ckpt_corrupt", step) is None or not write:
            return None
        from repro_torch.train import checkpoint as ckpt

        latest = ckpt.latest_step(directory)
        if latest is None:
            return None
        path = os.path.join(directory, f"step_{latest:08d}", "arrays.npz")
        try:
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(size // 2)
                chunk = f.read(64)
                f.seek(size // 2)
                f.write(bytes(b ^ 0xFF for b in chunk))
        except OSError:
            return None
        return path

    # -- serve-engine hooks -------------------------------------------------
    def serve_tick(self, tick: int) -> None:
        """Per-decode-tick hook, called BEFORE the tick dispatches (slot
        state untouched on raise, so a pre-dispatch retry is exact) by
        ``serve.sparse_decode.ContinuousServeEngine._chaos_tick``:

          collective  raises FaultInjectionError (engine retries on its
                      budget)
          nonfinite   raises NonFiniteEscalation (decode state is
                      donated — no in-place retry exists, so the engine
                      aborts cleanly with a blackbox)
          straggler / stall   block for duration_s (latency/SLO path —
                      token outputs are unaffected by wall time)
          sigterm     SIGTERM to the process
          ckpt_corrupt  no-op (serving has no checkpoints)
        """
        if self._take("collective", tick) is not None:
            raise FaultInjectionError(
                f"injected collective failure at decode tick {tick}")
        if self._take("nonfinite", tick) is not None:
            raise NonFiniteEscalation(
                f"injected non-finite logits at decode tick {tick}")
        for kind in ("straggler", "stall"):
            spec = self._take(kind, tick)
            if spec is not None and spec.duration_s > 0:
                time.sleep(spec.duration_s)
        if self._take("sigterm", tick) is not None:
            os.kill(os.getpid(), signal.SIGTERM)


# --------------------------------------------------------------------------
# Recovery policy — retry budgets + exponential backoff with jitter
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class RecoveryConfig:
    """The driver's recovery policy (DESIGN.md §12.3).

    ``max_consecutive_nonfinite`` is N of the guarded step's escalation
    rule: N consecutive tripped steps raise NonFiniteEscalation, which
    the supervisor answers with a rewind to the last-good checkpoint.
    ``budgets`` caps restore+retry attempts PER FAULT CLASS; the
    ``default`` key covers unlisted classes. Delays are exponential in
    the per-class attempt count, capped at ``backoff_max_s``, with a
    deterministic seeded jitter so co-failing replicas don't restore in
    lockstep."""

    max_consecutive_nonfinite: int = 3
    budgets: dict = field(default_factory=lambda: {
        "nonfinite": 2, "stall": 2, "ckpt_corrupt": 2, "collective": 3,
        "sigterm": 0, "default": 2,
    })
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def budget_for(self, cls: str) -> int:
        return int(self.budgets.get(cls, self.budgets.get("default", 2)))


class RetrySupervisor:
    """Bounded retry/backoff bookkeeping for one driver run.

    ``on_failure(exc, step)`` classifies the exception, charges the
    class's budget, and returns the jittered backoff delay to sleep
    before the restore — or raises :class:`RetryBudgetExhausted` (from
    the original exception) when the class is spent. Budgets are
    per-class and cumulative over the run: distinct fault classes don't
    steal each other's retries, and a flapping fault can't restart
    forever. Every decision is a ``recovery/*`` event."""

    def __init__(self, cfg: RecoveryConfig = RecoveryConfig(), *,
                 registry=None):
        self.cfg = cfg
        self.registry = registry
        self.attempts: dict[str, int] = {}
        self._rng = np.random.default_rng(cfg.seed)

    def _event(self, name: str, **fields) -> None:
        if self.registry is not None:
            self.registry.event(name, **fields)

    def backoff_s(self, cls: str) -> float:
        n = self.attempts.get(cls, 1)
        base = min(self.cfg.backoff_max_s,
                   self.cfg.backoff_base_s * (2.0 ** (n - 1)))
        return base * (1.0 + self.cfg.jitter * float(self._rng.random()))

    def on_failure(self, exc: BaseException, step: int) -> float:
        cls = classify_fault(exc)
        self.attempts[cls] = self.attempts.get(cls, 0) + 1
        n, budget = self.attempts[cls], self.cfg.budget_for(cls)
        if n > budget:
            if self.registry is not None:
                self.registry.counter("recovery/aborts").inc()
            self._event("recovery/abort", cls=cls, step=step,
                        attempts=n, budget=budget,
                        error=type(exc).__name__)
            raise RetryBudgetExhausted(
                f"fault class {cls!r} exhausted its retry budget "
                f"({budget}) at step {step}: {exc!r}") from exc
        delay = self.backoff_s(cls)
        if self.registry is not None:
            self.registry.counter("recovery/retries").inc()
            self.registry.counter(f"recovery/retries_{cls}").inc()
        self._event("recovery/retry", cls=cls, step=step, attempt=n,
                    budget=budget, delay_s=delay,
                    error=type(exc).__name__)
        return delay


def crc32_of(arr: np.ndarray) -> int:
    """The CRC32 the checkpoint integrity layer records per leaf —
    shared here so tests and tooling compute the identical digest."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF
