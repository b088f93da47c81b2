"""Continuous-batching request scheduler (DESIGN.md §8.1): the JAX
package's ``repro.serve.scheduler``, kept as the port's own copy (it is
host-only numpy), bit-identical in behaviour.

Pure host-side bookkeeping — no device code, no model knowledge. The
decode engine (serve/sparse_decode.py) asks three questions each step:

  admit_ready()     which waiting requests go into which free slots NOW
                    (FIFO by arrival; ragged prompt lengths are the
                    engine's problem — admission is per-request prefill)
  record(slot, tok) one decoded token landed in a slot; retire the slot
                    when the token is the EOS id (early-EOS retirement)
                    or the request's own max_new_tokens is reached
  advance()/skip()  move the step clock (skip fast-forwards an idle
                    engine to the next arrival instead of spinning)

The clock is counted in DECODE STEPS, not seconds: arrivals are given in
step units so runs are exactly reproducible and independent of host
speed. ``poisson_trace`` generates such arrivals from a seeded Poisson
process (exponential inter-arrival gaps at a given rate per step).

Per-request LIFECYCLE (DESIGN.md §10): admission and retirement stamp a
``lifecycle`` record per rid — arrival, admit clock, prompt length,
retire clock, emitted tokens — and :meth:`latency_stats` reduces those to
the serve latency distributions (queue delay, TTFT, TPOT, end-to-end),
all in the same deterministic step units, so percentiles over a fixed
Poisson trace are exactly reproducible.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Request:
    """One generation request. ``arrival`` is in decode-step units."""

    rid: int
    prompt: np.ndarray                 # (S,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        assert self.prompt.size >= 1, "empty prompt"
        assert self.max_new_tokens >= 1


@dataclass
class Slot:
    """One occupied decode slot (engine-facing view)."""

    rid: int
    next_token: int                    # token the next decode step consumes
    emitted: list = field(default_factory=list)
    max_new: int = 0


@dataclass(frozen=True)
class ServeConfig:
    """Operator-declared serving objectives (DESIGN.md §10.5).

    SLO targets are p99 bounds in the scheduler's deterministic
    DECODE-STEP units (the same units :meth:`ContinuousScheduler.
    latency_stats` reports), so attainment over a fixed Poisson trace is
    exactly reproducible. ``None`` leaves a dimension untargeted. The
    engine emits the declared targets as a ``serve/slo_targets`` event
    at end of run and hands them to the health engine
    (:class:`repro_torch.obs.health.HealthMonitor`), which turns misses into
    severity-ranked ``health/serve_slo`` events; ``repro_torch.obs.report``
    renders the attainment table from both."""

    slo_ttft_p99: Optional[float] = None         # admission -> first token
    slo_tpot_p99: Optional[float] = None         # steps per output token
    slo_queue_delay_p99: Optional[float] = None  # arrival -> admission
    slo_e2e_p99: Optional[float] = None          # arrival -> retirement
    # graceful degradation under overload (DESIGN.md §12.5): bound on
    # ARRIVED-but-unadmitted waiters (newest shed first when crossed),
    # and the queue-wait deadline in decode steps past which a request
    # is shed instead of admitted. Shedding is OPT-IN: slo_* targets
    # alone are monitoring declarations (missed targets become health
    # verdicts, DESIGN.md §10.5), never an admission policy. Once
    # shedding is enabled — a ``queue_limit`` or an explicit
    # ``shed_deadline`` — the deadline falls back to ``slo_ttft_p99``:
    # in this scheduler TTFT == queue delay, so an overdue request is
    # provably going to miss its TTFT target.
    queue_limit: Optional[int] = None
    shed_deadline: Optional[float] = None

    def effective_shed_deadline(self) -> Optional[float]:
        """The queue-wait bound shedding enforces: the explicit
        ``shed_deadline`` when set; the declared TTFT target when
        shedding was enabled via ``queue_limit``; None (shedding off)
        when neither degradation knob was touched."""
        if self.shed_deadline is not None:
            return float(self.shed_deadline)
        if self.queue_limit is None or self.slo_ttft_p99 is None:
            return None
        return float(self.slo_ttft_p99)

    def slo_targets(self) -> dict:
        """{latency key -> target}, omitting untargeted dimensions —
        the mapping HealthMonitor(serve_slo=...) consumes."""
        pairs = {"ttft": self.slo_ttft_p99, "tpot": self.slo_tpot_p99,
                 "queue_delay": self.slo_queue_delay_p99,
                 "e2e": self.slo_e2e_p99}
        return {k: float(v) for k, v in pairs.items() if v is not None}


def poisson_trace(n: int, rate: float, seed: int = 0,
                  start: float = 0.0) -> np.ndarray:
    """n Poisson arrival times (decode-step units) at ``rate`` requests
    per step: cumulative sum of seeded exponential gaps."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
    return start + np.cumsum(gaps)


class ContinuousScheduler:
    """Slot lifecycle over a fixed pool of ``num_slots`` decode slots.

    Requests wait in arrival order; a request is admissible once the
    step clock has passed its arrival AND a slot is free. Retirement
    frees the slot the same step, so the next waiting request can be
    admitted at the following boundary (continuous batching)."""

    def __init__(self, num_slots: int, requests: list[Request],
                 eos_id: Optional[int] = None):
        self.num_slots = int(num_slots)
        self.eos_id = eos_id
        self.waiting: deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self.slots: list[Optional[Slot]] = [None] * self.num_slots
        self.clock = 0.0
        self.completed: dict[int, np.ndarray] = {}
        self.retirements: list[tuple[float, int]] = []   # (clock, rid)
        self.shed: dict[int, str] = {}                   # rid -> reason
        # rid -> {arrival, admit, prompt_len, retire, tokens} (step units)
        self.lifecycle: dict[int, dict] = {
            r.rid: {"arrival": float(r.arrival), "admit": None,
                    "prompt_len": int(r.prompt.size), "retire": None,
                    "tokens": 0, "shed": None}
            for r in requests}

    # -- state queries -----------------------------------------------------
    @property
    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots], bool)

    @property
    def done(self) -> bool:
        return not self.waiting and self.active_count == 0

    def slot(self, i: int) -> Optional[Slot]:
        return self.slots[i]

    # -- admission ---------------------------------------------------------
    def admit_ready(self) -> list[tuple[int, Request]]:
        """(slot index, request) pairs to admit at this step boundary:
        FIFO over arrived requests, lowest free slot first. The caller
        (the engine) prefills each and then calls :meth:`install`."""
        out = []
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.waiting and self.waiting[0].arrival <= self.clock:
            out.append((free.pop(0), self.waiting.popleft()))
        return out

    def install(self, slot_idx: int, req: Request, first_token: int) -> bool:
        """Occupy a slot with a freshly prefilled request. The prefill's
        argmax IS the first emitted token (exactly as ServeEngine.generate
        counts it); a 1-token request (or an immediate EOS) retires on
        the spot. Returns True when the slot retired immediately."""
        assert self.slots[slot_idx] is None, slot_idx
        self.slots[slot_idx] = Slot(rid=req.rid, next_token=int(first_token),
                                    max_new=req.max_new_tokens)
        self.lifecycle[req.rid]["admit"] = self.clock
        return self.record(slot_idx, int(first_token))

    # -- load shedding (DESIGN.md §12.5) -----------------------------------
    def _shed(self, req: Request, reason: str) -> None:
        self.shed[req.rid] = reason
        lc = self.lifecycle[req.rid]
        lc["shed"] = self.clock
        lc["shed_reason"] = reason

    def shed_overdue(self, deadline: float) -> list[int]:
        """Shed every arrived-but-unadmitted request whose queue wait
        exceeds ``deadline`` steps. TTFT == queue delay here, so such a
        request has already lost its TTFT budget — rejecting it fast is
        strictly better than serving a guaranteed SLO miss. Returns the
        shed rids (FIFO order)."""
        out, keep = [], deque()
        while self.waiting:
            r = self.waiting.popleft()
            if r.arrival <= self.clock and self.clock - r.arrival > deadline:
                self._shed(r, "deadline")
                out.append(r.rid)
            else:
                keep.append(r)
        self.waiting = keep
        return out

    def shed_overflow(self, limit: int) -> list[int]:
        """Bounded admission queue: keep the oldest ``limit`` ARRIVED
        waiters, shed the newest beyond the bound (future arrivals in
        the trace don't count against it). Returns the shed rids."""
        arrived = [r for r in self.waiting if r.arrival <= self.clock]
        excess = len(arrived) - int(limit)
        if excess <= 0:
            return []
        victims = {r.rid for r in arrived[len(arrived) - excess:]}
        out, keep = [], deque()
        while self.waiting:
            r = self.waiting.popleft()
            if r.rid in victims:
                self._shed(r, "queue_full")
                out.append(r.rid)
            else:
                keep.append(r)
        self.waiting = keep
        return out

    # -- decode-step bookkeeping -------------------------------------------
    def record(self, slot_idx: int, token: int) -> bool:
        """One emitted token for an occupied slot; retires the slot on
        EOS or when max_new_tokens is reached. Returns True on retire."""
        s = self.slots[slot_idx]
        assert s is not None, slot_idx
        s.emitted.append(int(token))
        s.next_token = int(token)
        self.lifecycle[s.rid]["tokens"] = len(s.emitted)
        if (self.eos_id is not None and token == self.eos_id) \
                or len(s.emitted) >= s.max_new:
            self.completed[s.rid] = np.asarray(s.emitted, np.int32)
            self.retirements.append((self.clock, s.rid))
            self.lifecycle[s.rid]["retire"] = self.clock
            self.slots[slot_idx] = None
            return True
        return False

    def advance(self) -> None:
        self.clock += 1.0

    # -- latency distributions ---------------------------------------------
    def latency_stats(self) -> dict[str, np.ndarray]:
        """Per-retired-request latency arrays in DECODE-STEP units, one
        entry per completed rid (sorted), deterministic on a fixed trace:

          queue_delay  admit clock - arrival (waiting for a free slot)
          ttft         time to first token == queue_delay: the prefill's
                       argmax IS the first emitted token, landed at the
                       admission boundary (see :meth:`install`)
          tpot         (retire - admit) / (tokens - 1): per-token time of
                       the decode phase (0 for 1-token requests)
          e2e          retire clock - arrival

        Convert to seconds by multiplying with a measured step wall time
        (the engine reports ``wall_s / decode_steps``)."""
        done = sorted(rid for rid, lc in self.lifecycle.items()
                      if lc["retire"] is not None)
        q, tpot, e2e, toks = [], [], [], []
        for rid in done:
            lc = self.lifecycle[rid]
            q.append(lc["admit"] - lc["arrival"])
            n = max(1, lc["tokens"])
            tpot.append((lc["retire"] - lc["admit"]) / max(1, n - 1))
            e2e.append(lc["retire"] - lc["arrival"])
            toks.append(n)
        return {
            "rids": np.asarray(done, np.int64),
            "queue_delay": np.asarray(q, np.float64),
            "ttft": np.asarray(q, np.float64),
            "tpot": np.asarray(tpot, np.float64),
            "e2e": np.asarray(e2e, np.float64),
            "tokens": np.asarray(toks, np.int64),
        }

    def skip_to_next_arrival(self) -> None:
        """Idle engine (no active slots, nothing admissible): jump the
        clock to the next arrival instead of decoding empty batches."""
        if self.waiting:
            self.clock = max(self.clock, self.waiting[0].arrival)


def truncate_at_eos(tokens: np.ndarray, eos_id: Optional[int]) -> np.ndarray:
    """Reference-side helper: cut a greedy decode at (and including) the
    first EOS — what early-EOS retirement makes the scheduler emit."""
    tokens = np.asarray(tokens)
    if eos_id is None:
        return tokens
    hits = np.nonzero(tokens == eos_id)[0]
    return tokens[: hits[0] + 1] if hits.size else tokens
