"""Slot-based continuous-batching decode engine (the JAX package's
``repro.serve.sparse_decode``, DESIGN.md §8), for the dense family.

``build_slot_decode_step`` returns ONE decode step for a cache length:
per-slot positions (each request at its own depth in its own cache
rows) and the live-slot mask.

:class:`ContinuousServeEngine` is the host loop: a ContinuousScheduler
admits ragged prompts into free slots (a B = 1 prefill at the prompt's
own length, its caches copied into the slot's rows in place, its greedy
token the request's first), every step decodes one token for all active
slots, and early-EOS or maxed slots retire and free their slot. Load
shedding (``ServeConfig.queue_limit`` / ``shed_deadline``), the SLO
health verdicts and a pre-dispatch chaos hook with bounded retries
(``injector``) are the reference's.

Each decode step reads the device once: its (B,) greedy tokens, taken on
the device (``torch.argmax`` returns the first maximal index, as the
reference's ``np.argmax`` over the copied logits does). The tokens stay
on the device as the next step's input; an admission writes its first
token there and reads it once (the scheduler needs it at once).

Not ported yet (ROADMAP Queue 1 item 12, with the MoE family): the plan
path of the slot step (``plan`` is not None: the MoE combine exchange
through ``comm.executor.exchange_activation_spmd``), ``ServeDispatch``,
the engine's ``AdaptiveRuntime`` and its occupancy guard. On a dense
model the reference runs neither: there is no cross-device dispatch to
plan, so ``dispatch="adaptive"`` serves exactly as ``"dense"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import resolve as _resolve_obs
from repro_torch.runtime.faults import FaultInjectionError
from repro_torch.serve.engine import build_serve_step, greedy
from repro_torch.serve.scheduler import ContinuousScheduler, Request


# --------------------------------------------------------------------------
# The slot decode step
# --------------------------------------------------------------------------

def build_slot_decode_step(model: Model, plan, cache_len: int):
    """fn(params, state, tokens, active) -> (logits, state', telem).

    ``state.pos`` is the (B,) per-slot position vector; ``active`` the
    (B,) live-slot mask (host numpy: the dense step reads no mask, every
    row is computed and an inactive row's output is never read). ``telem``
    is empty: it maps the MoE plan's activation bucket to its telemetry,
    and a ``plan`` (the MoE path) raises."""
    if plan is not None:
        raise NotImplementedError(
            "the slot decode step's plan path serves the MoE family, which "
            "is not ported yet (ROADMAP Queue 1 item 12)")
    step = build_serve_step(model, cache_len)

    def slot_step(params, state, tokens, active):
        logits, state = step(params, state, tokens)
        return logits, state, {}

    return slot_step


def insert_slot_state(cfg, state, sub, slot_idx: int):
    """Copy a B = 1 prefill's caches into slot ``slot_idx`` of the batch
    decode state, and its position into the slot's entry of the per-slot
    position vector, IN PLACE (the reference returns an updated copy of
    its donated state). The slot's previous content, a retired request's,
    is fully overwritten; nothing else moves. Returns ``state``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"continuous batching: family {cfg.family!r} is not ported yet "
            "(ROADMAP Queue 1 item 12)")
    state.kv.k[:, slot_idx] = sub.kv.k[:, 0]
    state.kv.v[:, slot_idx] = sub.kv.v[:, 0]
    state.pos[slot_idx] = sub.pos
    return state


def _readback(tokens: torch.Tensor) -> np.ndarray:
    """The engine's one host wait a decode step (and an admission): the
    step's greedy tokens to the host."""
    return tokens.cpu().numpy()


# --------------------------------------------------------------------------
# The continuous-batching engine
# --------------------------------------------------------------------------

@dataclass
class ServeResult:
    """What one ``ContinuousServeEngine.run`` produced."""

    outputs: dict                      # rid -> np.int32 emitted tokens
    decode_steps: int = 0
    tokens: int = 0                    # total emitted (incl. prefill argmax)
    wall_s: float = 0.0
    wire_bytes: float = 0.0            # modeled per-rank dispatch bytes, total
    swap_log: list = field(default_factory=list)
    step_log: list = field(default_factory=list)
    # per-retired-request latency percentiles in DECODE-STEP units
    # (deterministic on a fixed trace): {metric: {p50, p90, p99, mean}}
    latency: dict = field(default_factory=dict)
    # HealthEvent verdicts from the end-of-run SLO evaluation (empty
    # without a ServeConfig carrying targets, or with metrics off),
    # plus the backpressure verdict whenever requests were shed
    health: list = field(default_factory=list)
    # rid -> reason for requests load-shed instead of served
    # (DESIGN.md §12.5); disjoint from ``outputs``
    shed: dict = field(default_factory=dict)

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0


class ContinuousServeEngine:
    """Continuous-batching greedy decoding over ``batch_size`` slots, on
    the card unless ``device`` says otherwise.

    ``dispatch`` ('dense' or 'adaptive') picks the MoE combine's wire in
    the reference; the dense family has none, so both serve the same way
    and no controller runs. ``serve_cfg`` (a ServeConfig) declares SLO
    targets and the load-shedding policy; ``injector`` (a FaultInjector)
    is called once a decode tick before dispatch, its collective faults
    retried up to ``max_tick_retries`` times."""

    def __init__(self, model: Model, params, cache_len: int = 128,
                 batch_size: int = 8, dispatch: str = "adaptive",
                 eos_id: Optional[int] = None, obs=None, serve_cfg=None,
                 injector=None, max_tick_retries: int = 3, device="cuda"):
        if dispatch not in ("dense", "adaptive"):
            raise ValueError(f"dispatch {dispatch!r}: 'dense' or 'adaptive'")
        cfg = model.cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                f"continuous batching: family {cfg.family!r} is not ported "
                "yet (ROADMAP Queue 1 item 12)")
        self.serve_cfg = serve_cfg
        self.injector = injector
        self.max_tick_retries = int(max_tick_retries)
        self.model, self.params = model, params
        self.cache_len, self.batch_size = cache_len, batch_size
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.obs = _resolve_obs(obs)
        if injector is not None:
            injector.bind(
                registry=self.obs.metrics if self.obs.metrics_on else None)
        self.swap_log: list = []
        self._fn = build_slot_decode_step(model, None, cache_len)

    # -- slot admission ----------------------------------------------------
    def _admit(self, state, tokens, slot_idx: int, req: Request) -> int:
        """Per-request ragged prefill: run the prompt at its own length
        (B = 1), take the first greedy token from the prefill logits,
        exactly as ServeEngine.generate does, and copy the caches into the
        slot's rows. The token goes into the slot's entry of ``tokens``
        (the next step's input) and to the host."""
        if req.prompt.size + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt.size} + "
                f"{req.max_new_tokens} new tokens exceed the cache length "
                f"{self.cache_len}")
        prompt = torch.from_numpy(req.prompt[None])
        if self.device.type == "cuda":   # a copy the host does not wait for
            prompt = prompt.pin_memory().to(self.device, non_blocking=True)
        logits, sub = self.model.prefill(self.params, {"tokens": prompt},
                                         self.cache_len)
        insert_slot_state(self.model.cfg, state, sub, slot_idx)
        first = greedy(logits)
        tokens[slot_idx] = first[0]
        return int(_readback(first)[0])

    # -- the serving loop --------------------------------------------------
    def run(self, requests: list[Request],
            max_steps: int = 100_000) -> ServeResult:
        sched = ContinuousScheduler(self.batch_size, requests,
                                    eos_id=self.eos_id)
        self.swap_log = []
        state = self.model.init_decode_state(self.batch_size, self.cache_len,
                                             device=self.device)
        state = state._replace(pos=torch.zeros(
            (self.batch_size,), dtype=torch.int32, device=self.device))
        tokens = torch.zeros((self.batch_size,), dtype=torch.int32,
                             device=self.device)
        res = ServeResult(outputs=sched.completed, swap_log=self.swap_log)
        t0 = time.perf_counter()
        obs = self.obs
        rec = getattr(obs, "recorder", None)
        if self.injector is not None:
            # re-bind per run: the injector (and the obs handle it counts
            # through) may have been swapped since construction
            self.injector.bind(
                registry=obs.metrics if obs.metrics_on else None)
        try:
            self._run_loop(sched, state, tokens, res, max_steps)
        except Exception as e:
            # flight-recorder trigger (DESIGN.md §10.6): leave a
            # parseable blackbox behind before surfacing the failure
            if rec is not None:
                rec._safe_dump(f"exception:{type(e).__name__}")
            raise
        res.wall_s = time.perf_counter() - t0
        res.shed = dict(sched.shed)
        stats = sched.latency_stats()
        res.latency = {
            name: {"p50": float(np.percentile(v, 50)),
                   "p90": float(np.percentile(v, 90)),
                   "p99": float(np.percentile(v, 99)),
                   "mean": float(np.mean(v))}
            for name, v in stats.items()
            if name in ("queue_delay", "ttft", "tpot", "e2e") and v.size
        }
        if obs.metrics_on:
            m = obs.metrics
            for name in ("queue_delay", "ttft", "tpot", "e2e"):
                if stats[name].size:
                    m.histogram(f"serve/{name}_steps").observe_many(
                        stats[name])
            m.gauge("serve/tok_per_s").set(res.tok_per_s)
            m.gauge("serve/decode_steps").set(res.decode_steps)
            targets = (self.serve_cfg.slo_targets()
                       if self.serve_cfg is not None else {})
            if targets:
                # declared objectives ride the JSONL so the report CLI
                # can join them against the measured percentiles, and
                # the health engine ranks the misses
                from repro_torch.obs.health import HealthMonitor

                m.event("serve/slo_targets", **targets)
                res.health = HealthMonitor(
                    m, serve_slo=targets, audit=obs.audit).evaluate()
        if res.shed:
            # backpressure verdict (DESIGN.md §12.5): shedding is the
            # degradation policy WORKING, but the operator must see it:
            # a warn-level health event rides the result and the JSONL
            from repro_torch.obs.health import HealthEvent, rank_events

            counts: dict = {}
            for reason in res.shed.values():
                counts[reason] = counts.get(reason, 0) + 1
            by = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
            ev = HealthEvent(
                "warn", "serve_shed", "admission",
                f"{len(res.shed)} of {len(res.shed) + len(res.outputs)} "
                f"requests load-shed under backpressure ({by})",
                float(len(res.shed)), 0.0)
            res.health = rank_events(list(res.health) + [ev])
            if obs.metrics_on:
                obs.metrics.event(
                    "health/serve_shed", severity=ev.severity,
                    subject=ev.subject, value=ev.value,
                    threshold=ev.threshold, message=ev.message)
        return res

    def _shed_pass(self, sched, obs, *, deadline: bool = False,
                   overflow: bool = False) -> None:
        """Graceful degradation (DESIGN.md §12.5). ``deadline`` runs
        BEFORE admission (an overdue request's TTFT budget is spent: it
        must not take a slot from one that can still meet it);
        ``overflow`` runs AFTER (free slots absorb the burst first, the
        bounded queue only sheds what admission could not place).
        Shedding instead of queueing keeps the served requests' outputs
        and latencies identical to an unloaded run."""
        scfg = self.serve_cfg
        if scfg is None:
            return
        shed_now = []
        limit = scfg.effective_shed_deadline()
        if deadline and limit is not None:
            shed_now += [(rid, "deadline")
                         for rid in sched.shed_overdue(limit)]
        if overflow and scfg.queue_limit is not None:
            shed_now += [(rid, "queue_full")
                         for rid in sched.shed_overflow(scfg.queue_limit)]
        for rid, reason in shed_now:
            obs.event("serve/shed", rid=rid, reason=reason,
                      step=sched.clock)
            if obs.metrics_on:
                obs.metrics.counter("serve/shed_requests").inc()
                obs.metrics.counter(f"serve/shed_{reason}").inc()

    def _chaos_tick(self, tick: int, clock: float, obs) -> None:
        """Pre-dispatch injection point with a bounded retry: a
        collective fault raised here touched nothing (the step that
        writes the decode state has not been dispatched), so retrying is
        safe. Injected one-shots clear on the retry; a genuinely stuck
        fault exhausts ``max_tick_retries`` and aborts with the
        blackbox."""
        for attempt in range(1, self.max_tick_retries + 1):
            try:
                self.injector.serve_tick(tick)
                return
            except FaultInjectionError as e:
                if attempt >= self.max_tick_retries:
                    raise
                if obs.metrics_on:
                    obs.metrics.counter("serve/retries").inc()
                obs.event("recovery/serve_retry", step=clock,
                          attempt=attempt, error=type(e).__name__,
                          message=str(e))

    def _run_loop(self, sched, state, tokens, res, max_steps: int):
        obs = self.obs
        rec = getattr(obs, "recorder", None)
        while not sched.done and res.decode_steps < max_steps:
            self._shed_pass(sched, obs, deadline=True)
            for slot_idx, req in sched.admit_ready():
                with obs.span("serve/admit", rid=req.rid, slot=slot_idx,
                              prompt_len=int(req.prompt.size)):
                    first = self._admit(state, tokens, slot_idx, req)
                sched.install(slot_idx, req, first)
                res.tokens += 1
            self._shed_pass(sched, obs, overflow=True)
            active = sched.active_mask
            n_active = int(active.sum())
            if n_active == 0:
                sched.skip_to_next_arrival()
                continue
            if self.injector is not None:
                self._chaos_tick(res.decode_steps, sched.clock, obs)
            with obs.span("serve/decode_step", step=sched.clock,
                          active=n_active):
                logits, state, _ = self._fn(self.params, state,
                                            tokens[:, None], active)
                tokens = greedy(logits)
                host = _readback(tokens)
            for i in np.nonzero(active)[0]:
                sched.record(int(i), int(host[i]))
                res.tokens += 1
            res.step_log.append({"step": sched.clock, "active": n_active,
                                 "wire_bytes": 0.0, "signature": "-"})
            if rec is not None:
                rec.note("serve/step", step=sched.clock, active=n_active,
                         wire_bytes=0.0)
            if obs.metrics_on:
                m = obs.metrics
                m.histogram("serve/occupancy").observe(n_active)
                m.histogram("serve/queue_depth").observe(len(sched.waiting))
            sched.advance()
            res.decode_steps += 1
