"""Slot-based decode engine with plan-driven sparse expert dispatch (the
JAX package's ``repro.serve.sparse_decode``, DESIGN.md §8).

``build_slot_decode_step`` returns ONE decode step for a (cache length,
ServePlan signature) pair: per-slot positions (each request at its own
depth in its own cache rows), the live-slot mask, and, for the MoE
family, the combine exchange through the comm plan
(``exchange_activation_spmd``: the dense sum or the (idx, val) row-stream
wire, bit-identical while under the stream's capacity).

:class:`ContinuousServeEngine` is the host loop: a ContinuousScheduler
admits ragged prompts into free slots (a B = 1 prefill at the prompt's
own length, its caches copied into the slot's rows in place, its greedy
token the request's first), every step decodes one token for all active
slots, and early-EOS or maxed slots retire and free their slot. On a MoE
model in adaptive dispatch mode, the step's telemetry ([active-token
nnz, wire bytes], the shape of the training executor's) feeds the
``AdaptiveController``; accepted replans swap the slot step from a cache
keyed by plan signature at step barriers, and the occupancy guard
force-demotes a stream plan whose capacity the admitted batch just
crossed (a correctness rule, past hysteresis and patience). Load
shedding (``ServeConfig.queue_limit`` / ``shed_deadline``), the SLO
health verdicts and a pre-dispatch chaos hook with bounded retries
(``injector``) are the reference's.

The engine has no mesh: the expert shards of the combine are stacked on
the device (``p_model`` of them, 2 by default as the example's ``model``
axis), so the exchange is the sum over that axis. The adaptive engine
needs ``net=`` (NetworkParams): the port has no default network, and
``utils/calibrate.py`` fits one.

Each decode step reads the device once: its (B,) greedy tokens, taken on
the device (``torch.argmax`` returns the first maximal index, as the
reference's ``np.argmax`` over the copied logits does). The tokens stay
on the device as the next step's input; an admission writes its first
token there and reads it once (the scheduler needs it at once). The
plan path's telemetry is known on the host (the active count and the
plan's wire bytes) and is never read back; its live mask goes up by a
pinned, non-blocking copy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.comm.executor import exchange_activation_spmd
from repro_torch.comm.plan import ServePlan, build_serve_plan
from repro_torch.core.cost_model import NetworkParams
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.moe import ServeDispatch
from repro_torch.obs import resolve as _resolve_obs
from repro_torch.runtime.adapt import AdaptConfig, AdaptiveRuntime
from repro_torch.runtime.faults import FaultInjectionError
from repro_torch.serve.engine import build_serve_step, greedy
from repro_torch.serve.scheduler import ContinuousScheduler, Request


# --------------------------------------------------------------------------
# The slot decode step
# --------------------------------------------------------------------------

def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host wait (pinned, non-blocking
    copy to the card)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def build_slot_decode_step(model: Model, plan: Optional[ServePlan],
                           cache_len: int):
    """fn(params, state, tokens, active) -> (logits, state', telem).

    ``state.pos`` is the (B,) per-slot position vector; ``active`` the
    (B,) live-slot mask, host numpy. ``plan`` (MoE families) pins the
    combine exchange's wire (its signature is the step cache's key);
    ``telem`` maps the plan's activation bucket to a (2,) f32 host array
    [active nnz, modeled wire bytes], the shape the adaptive controller
    consumes. Without a plan (dense families) the step reads no mask
    (every row is computed, an inactive row's output is never read) and
    ``telem`` is empty."""
    step = build_serve_step(model, cache_len)
    if plan is None:
        def slot_step(params, state, tokens, active):
            logits, state = step(params, state, tokens)
            return logits, state, {}

        return slot_step

    bucket = plan.buckets[0]
    algorithm, bname = bucket.algorithm, bucket.name
    wire = plan.wire_bytes()
    p_model = plan.dp_total

    def exchange(parts):
        return exchange_activation_spmd(parts, algorithm)

    def slot_step(params, state, tokens, active):
        md = ServeDispatch(active=_to_device(np.asarray(active, bool),
                                             tokens.device),
                           exchange=exchange, p_shards=p_model)
        logits, state = step(params, state, tokens, moe_serve=md)
        telem = {bname: np.array([np.count_nonzero(active), wire],
                                 np.float32)}
        return logits, state, telem

    return slot_step


def insert_slot_state(cfg, state, sub, slot_idx: int):
    """Copy a B = 1 prefill's caches and SSM states into slot ``slot_idx``
    of the batch decode state, and its position into the slot's entry of
    the per-slot position vector, IN PLACE (the reference returns an
    updated copy of its donated state). The batch axis is axis 1 of every
    stacked cache of the families served here (the vlm's nested self-
    attention cache would have it at 2, and the vlm is refused, as in the
    reference). The slot's previous content, a retired request's, is fully
    overwritten; nothing else moves. Returns ``state``."""
    if cfg.family == "vlm":
        raise NotImplementedError("continuous batching: vlm caches")
    for name in ("kv", "conv", "ssm"):
        dst, src = getattr(state, name), getattr(sub, name)
        if dst is None:
            continue
        for d, s in (zip(dst, src) if name == "kv" else [(dst, src)]):
            d[:, slot_idx] = s[:, 0]
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

    On a MoE model ``dispatch`` picks the combine's wire:

    dispatch='dense'     the exact reference: every step's MoE combine is
                         the dense sum, whatever the occupancy.
    dispatch='adaptive'  plan-driven: starts dense (exact at any
                         occupancy); the controller demotes to the
                         row-stream wire as the telemetry window shows
                         occupancy draining, and back up as it rises,
                         swapping slot steps by plan signature. The output
                         is bit-identical to 'dense' (the stream exchange
                         is exact under its capacity, which the occupancy
                         guard enforces). Needs ``net`` (NetworkParams).

    ``p_model``: the expert shards the combine sums over (stacked on the
    device); ``adapt``, ``min_cap`` and ``headroom`` tune the controller
    and the serve plan. The dense family has no cross-shard dispatch to
    plan, so both modes serve the same way and no controller runs.
    ``serve_cfg`` (a ServeConfig) declares SLO targets and the
    load-shedding policy; ``injector`` (a FaultInjector) is called once a
    decode tick before dispatch, its collective faults retried up to
    ``max_tick_retries`` times."""

    def __init__(self, model: Model, params, cache_len: int = 128,
                 batch_size: int = 8, dispatch: str = "adaptive",
                 eos_id: Optional[int] = None,
                 adapt: Optional[AdaptConfig] = None,
                 net: Optional[NetworkParams] = None, p_model: int = 2,
                 min_cap: int = 4, headroom: float = 2.0, obs=None,
                 serve_cfg=None, injector=None, max_tick_retries: int = 3,
                 device="cuda"):
        if dispatch not in ("dense", "adaptive"):
            raise ValueError(f"dispatch {dispatch!r}: 'dense' or 'adaptive'")
        cfg = model.cfg
        if cfg.family == "vlm" or not cfg.is_decoder:
            raise NotImplementedError(
                f"continuous batching: family {cfg.family!r}")
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
        self.runtime = None
        self._plan = None
        self.swap_log: list = []
        if cfg.family != "moe":
            self._fn = self._build(None)
            return
        base = build_serve_plan(p_model, batch_size, cfg.d_model,
                                algorithm="dense", min_cap=min_cap,
                                headroom=headroom)
        if dispatch == "dense":
            self._plan = base
            self._fn = self._build(base)
            return
        if net is None:
            raise ValueError(
                "dispatch='adaptive' needs net= (NetworkParams): the port "
                "carries no default network; utils/calibrate.py fits one")
        acfg = adapt or AdaptConfig(window=4, hysteresis=0.2, patience=1,
                                    calibrate=False, pod_sparse=False)
        self.runtime = AdaptiveRuntime(model, None, p_model, self.device,
                                       plan=base, net=net, cfg=acfg,
                                       obs=self.obs, build_fn=self._build)
        self._plan = self.runtime.current_plan
        self._fn = self.runtime.current_fn()

    def _build(self, plan):
        return build_slot_decode_step(self.model, plan, self.cache_len)

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
        prompt = _to_device(req.prompt[None], self.device)
        logits, sub = self.model.prefill(self.params, {"tokens": prompt},
                                         self.cache_len)
        insert_slot_state(self.model.cfg, state, sub, slot_idx)
        first = greedy(logits)
        tokens[slot_idx] = first[0]
        return int(_readback(first)[0])

    # -- plan swaps --------------------------------------------------------
    def _install(self, fn, plan, clock: float, reason: str):
        self._fn, self._plan = fn, plan
        self.swap_log.append({"step": clock, "reason": reason,
                              "signature": plan.signature(),
                              "version": plan.version})
        self.obs.event("serve/plan_swap", step=clock, reason=reason,
                       signature=plan.signature(), version=plan.version)

    def _occupancy_guard(self, active_count: int, clock: float):
        """Force-demote a stream plan the admitted batch just outgrew: the
        stream would silently drop rows above its capacity. Runs BEFORE
        dispatch (the controller's windowed view lags by design) and
        bypasses hysteresis and patience, like the delta rule."""
        plan = self._plan
        if plan is None:
            return
        b = plan.buckets[0]
        if b.sparse and active_count > b.cap:
            forced = plan.replan(algorithms={b.name: "dense"})
            if self.runtime is not None:
                self.runtime.controller.force(forced)
                fn = self.runtime.step_fn_for(forced)
            else:
                fn = self._build(forced)
            self._install(fn, forced, clock, "occupancy-guard")

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
            self._occupancy_guard(n_active, sched.clock)
            if self.injector is not None:
                self._chaos_tick(res.decode_steps, sched.clock, obs)
            with obs.span("serve/decode_step", step=sched.clock,
                          active=n_active):
                logits, state, telem = self._fn(self.params, state,
                                                tokens[:, None], active)
                tokens = greedy(logits)
                host = _readback(tokens)
            for i in np.nonzero(active)[0]:
                sched.record(int(i), int(host[i]))
                res.tokens += 1
            wire = (float(telem[self._plan.buckets[0].name][1]) if telem
                    else 0.0)
            res.wire_bytes += wire
            res.step_log.append({
                "step": sched.clock, "active": n_active, "wire_bytes": wire,
                "signature": (self._plan.signature()
                              if self._plan is not None else "-")})
            if rec is not None:
                rec.note("serve/step", step=sched.clock, active=n_active,
                         wire_bytes=wire)
            if obs.metrics_on:
                m = obs.metrics
                m.histogram("serve/occupancy").observe(n_active)
                m.histogram("serve/queue_depth").observe(len(sched.waiting))
                if telem:
                    m.histogram("serve/wire_bytes").observe(wire)
            if self.runtime is not None and telem:
                self.runtime.observe(res.decode_steps, 1,
                                     {"telemetry": telem})
                sw = self.runtime.maybe_swap()
                if sw is not None:
                    # every step boundary of this synchronous host loop is
                    # a drain barrier: nothing is in flight at the swap
                    self._install(sw[0], sw[1], sched.clock, "telemetry")
            sched.advance()
            res.decode_steps += 1
