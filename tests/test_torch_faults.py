"""The port's fault-tolerant runtime (``repro_torch.runtime.faults``, the
driver's recovery and injection hooks, the Trainer's chaos run) against
the JAX package's (``tests/test_faults.py``), and against the port's own
clean runs.

* plans, the taxonomy, the supervisor and the injector are host Python:
  the same seed gives the reference's ``FaultPlan.chaos`` specs and the
  supervisor's jittered delays, exactly;
* the guarded, injectable step skips a poisoned step with params,
  moments, residuals and in-flight buffers bit for bit as before it, on
  both lowerings, and an all-zero fault vector is bit-exact with no
  injector;
* every recovery (an escalation rewind, a collective retry, a stalled or
  crashing prefetch, a straggler) ends bit-equal to the clean run: the
  replayed steps run clean (the injector's one-shot rule), and the data
  and QSGD bits are keyed by step. Exhausted budgets and SIGTERM abort
  cleanly, blackbox first.

The driver matrix runs one guarded step at staleness 0 with ZeRO-1 (the
default), so a rewind to a checkpoint loses nothing. The serve cases
wait for the serving slice (ROADMAP Queue 1 item 11).
"""
import json
import signal

import numpy as np
import pytest
import torch

from repro.runtime import faults as jax_faults
from repro_torch import obs as obs_mod
from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.obs.health import HealthMonitor
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime import driver as rt_driver
from repro_torch.runtime import pipeline as rt_pipeline
from repro_torch.runtime.faults import (FAULT_CLASSES, FAULT_KEY,
                                        FaultInjectionError, FaultInjector,
                                        FaultPlan, FaultSpec,
                                        NonFiniteEscalation, PrefetchStalled,
                                        RecoveryConfig, RetryBudgetExhausted,
                                        RetrySupervisor, classify_fault,
                                        crc32_of)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_leaves

P_DATA = 4
TINY = dict(name="ft", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
TCFG = TrainConfig(
    sync=SyncConfig(mode="sparcml", k_per_bucket=8, bucket_size=128,
                    algorithm="dsar_split_allgather", qsgd_bits=4,
                    qsgd_bucket=128, min_sparse_size=1024),
    optimizer=OptimizerConfig(),
    schedule=ScheduleConfig(peak_lr=3e-3, warmup_steps=5, total_steps=100))
DCFG = DataConfig(global_batch=8, seq_len=16, vocab_size=256)
N = 8              # driver-run length of every matrix entry
CKPT_EVERY = 2
# a fast supervisor: the real backoff policy, negligible sleeps
FAST_RECOVERY = RecoveryConfig(backoff_base_s=0.001, backoff_max_s=0.005)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The models here are tiny: two threads do, and the other test
    workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_model(ModelConfig(**TINY, dtype=torch.float32,
                                   param_dtype=torch.float32))


@pytest.fixture(scope="module")
def guarded_fn(model):
    """One guarded, injectable pipelined step at staleness 0 (no in-flight
    buffers: a rewind to a checkpoint loses nothing), shared by the whole
    driver matrix."""
    return rt_pipeline.build_pipelined_step(
        model, TCFG, P_DATA, "cpu", staleness=0, guard=True, inject=True,
        telemetry=False)


def _obs_with_metrics(recorder_path=None):
    ob = obs_mod.configure(metrics=True, set_as_default=False)
    if recorder_path is not None:
        ob.recorder = FlightRecorder(str(recorder_path), obs=ob)
    return ob


def _fresh(model, plan):
    return ts.init_state(model, TCFG, plan, "cpu")


def _drive(fn, plan, model, *, injector, obs, ckpt_dir=None, recovery=None,
           num_steps=N, timeout_s=60.0, batch_fn=None):
    """The shared guarded step under the async driver, with the standard
    checkpoint wiring (a CRC-verified fallback restore)."""
    ckpt_fn = restore_fn = None
    if ckpt_dir is not None:
        d = str(ckpt_dir)

        def ckpt_fn(s):
            ckpt.save(d, s, dp_total=P_DATA,
                      opt_layout=ckpt.opt_layout_of(TCFG))

        def restore_fn():
            return ckpt.restore(d, _fresh(model, plan), dp_total=P_DATA,
                                step=ckpt.latest_valid_step(d), verify=True)

    state = _fresh(model, plan)
    injector.bind(n_leaves=len(tree_leaves(state.params)))
    return rt_driver.run_pipelined(
        fn, state, start_step=0, num_steps=num_steps,
        batch_fn=batch_fn or (lambda s: synthetic_batch(DCFG, s)),
        cfg=rt_driver.DriverConfig(depth=1, prefetch=1,
                                   prefetch_timeout_s=timeout_s),
        ckpt_every=CKPT_EVERY if ckpt_dir else None,
        ckpt_fn=ckpt_fn, restore_fn=restore_fn, obs=obs, recovery=recovery,
        injector=injector)


def _state_leaves(state):
    return [*tree_leaves(state.params), *tree_leaves(state.opt),
            *tree_leaves(state.residuals)]


def _assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def clean_run(guarded_fn, model, tmp_path_factory):
    """The uninjected reference: the same step and checkpoint wiring, an
    EMPTY fault plan (the hooks run, nothing fires); every bit-equality
    claim of the matrix compares against it."""
    fn, plan = guarded_fn
    state, log = _drive(fn, plan, model, injector=FaultInjector(FaultPlan()),
                        obs=_obs_with_metrics(),
                        ckpt_dir=tmp_path_factory.mktemp("clean_ck"))
    return {"losses": list(log.losses), "state": _state_leaves(state)}


# --------------------------------------------------------------------------
# plans, classification, the supervisor, the injector
# --------------------------------------------------------------------------

def _specs(plan):
    return [(s.kind, s.step, s.mode, s.leaves, s.factor, s.duration_s,
             s.rank, s.repeat) for s in plan.specs]


def test_fault_spec_and_chaos_plan_deterministic():
    with pytest.raises(ValueError):
        FaultSpec(kind="nope", step=1)
    with pytest.raises(ValueError):
        FaultSpec(kind="nonfinite", step=1, mode="weird")
    with pytest.raises(ValueError):
        FaultSpec(kind="stall", step=1, repeat=0)
    a = FaultPlan.chaos(7, 64, ckpt_every=8)
    assert a == FaultPlan.chaos(7, 64, ckpt_every=8)
    assert a != FaultPlan.chaos(8, 64, ckpt_every=8)
    kinds = [s.kind for s in a.specs]
    for k in ("nonfinite", "straggler", "stall", "collective",
              "ckpt_corrupt"):
        assert k in kinds
    assert all(2 <= s.step <= 62 for s in a.specs)
    assert len(a.by_kind("stall")) == 1
    assert FAULT_CLASSES == jax_faults.FAULT_CLASSES
    assert FAULT_KEY == jax_faults.FAULT_KEY


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("steps,every", [(30, 10), (64, 8), (12, None)])
def test_chaos_plan_matches_reference(seed, steps, every):
    """Both draw from numpy's default_rng(seed): the same specs."""
    got = FaultPlan.chaos(seed, steps, ckpt_every=every)
    want = jax_faults.FaultPlan.chaos(seed, steps, ckpt_every=every)
    assert _specs(got) == _specs(want) and got.seed == want.seed
    single = FaultPlan.single("straggler", 3, factor=2.0, rank=1)
    assert _specs(single) == _specs(jax_faults.FaultPlan.single(
        "straggler", 3, factor=2.0, rank=1))


def test_classify_fault_taxonomy():
    for cls, jcls in ((NonFiniteEscalation, jax_faults.NonFiniteEscalation),
                      (PrefetchStalled, jax_faults.PrefetchStalled),
                      (FaultInjectionError, jax_faults.FaultInjectionError)):
        assert classify_fault(cls("x")) == jax_faults.classify_fault(jcls("x"))
    assert classify_fault(NonFiniteEscalation("x")) == "nonfinite"
    assert classify_fault(PrefetchStalled("x")) == "stall"
    assert classify_fault(ckpt.CheckpointCorrupt("x")) == "ckpt_corrupt"
    assert classify_fault(OSError("x")) == "ckpt_corrupt"
    assert classify_fault(FaultInjectionError("x")) == "collective"
    assert classify_fault(KeyboardInterrupt()) == "sigterm"
    # unknown failures (a CUDA error among them) retry on the generic one
    assert classify_fault(RuntimeError("CUDA error: an illegal memory "
                                       "access was encountered")) == \
        "collective"
    assert crc32_of(np.arange(5, dtype=np.int32)) == \
        jax_faults.crc32_of(np.arange(5, dtype=np.int32))


def test_retry_supervisor_budget_and_backoff():
    reg = MetricsRegistry(enabled=True)
    cfg = RecoveryConfig(budgets={"collective": 2, "default": 1},
                         backoff_base_s=0.1, backoff_max_s=0.3, jitter=0.5)
    sup = RetrySupervisor(cfg, registry=reg)
    ref = jax_faults.RetrySupervisor(jax_faults.RecoveryConfig(
        budgets={"collective": 2, "default": 1}, backoff_base_s=0.1,
        backoff_max_s=0.3, jitter=0.5))
    d1 = sup.on_failure(FaultInjectionError("a"), step=3)
    d2 = sup.on_failure(FaultInjectionError("b"), step=4)
    # the reference's delays, jitter draws included
    assert d1 == ref.on_failure(jax_faults.FaultInjectionError("a"), 3)
    assert d2 == ref.on_failure(jax_faults.FaultInjectionError("b"), 4)
    assert 0.1 <= d1 <= 0.1 * 1.5 and 0.2 <= d2 <= 0.2 * 1.5
    with pytest.raises(RetryBudgetExhausted) as ei:
        sup.on_failure(FaultInjectionError("c"), step=5)
    assert isinstance(ei.value.__cause__, FaultInjectionError)
    sup.on_failure(PrefetchStalled("s"), step=6)   # classes: own budgets
    assert reg.counter("recovery/retries").value == 3
    assert reg.counter("recovery/retries_collective").value == 2
    assert reg.counter("recovery/retries_stall").value == 1
    assert reg.counter("recovery/aborts").value == 1
    assert len(reg.events_named("recovery/retry")) == 3
    assert len(reg.events_named("recovery/abort")) == 1
    for _ in range(10):
        sup.attempts["stall"] += 1
    assert sup.backoff_s("stall") <= 0.3 * 1.5


def test_injector_one_shot_and_batch_wrap():
    reg = MetricsRegistry(enabled=True)
    plan = FaultPlan(specs=(
        FaultSpec(kind="nonfinite", step=2, mode="inf", leaves=(0, 2),
                  repeat=2),
        FaultSpec(kind="stall", step=1, duration_s=0.0)))
    inj = FaultInjector(plan).bind(n_leaves=4, registry=reg)
    assert inj.grad_flag(0).tolist() == [0, 0, 0, 0]
    assert inj.grad_flag(2).tolist() == [2, 0, 2, 0]   # inf -> flag 2
    assert inj.grad_flag(3).tolist() == [2, 0, 2, 0]   # repeat covers 3
    assert inj.grad_flag(4).tolist() == [0, 0, 0, 0]
    assert inj.grad_flag(2).tolist() == [0, 0, 0, 0]   # one-shot: spent
    b = inj.wrap_batch_fn(lambda s: {"tokens": np.zeros(2)})(1)
    assert FAULT_KEY in b and b[FAULT_KEY].shape == (4,)
    assert inj.fired_total == 3
    assert reg.counter("faults/injected_nonfinite").value == 2
    assert reg.counter("faults/injected_stall").value == 1
    assert [e["fault"] for e in reg.events_named("faults/injected")] == \
        ["nonfinite", "nonfinite", "stall"]


def test_process_group_fault_hooks(tmp_path):
    """One rank a process: a process that did not write the checkpoint
    counts the scheduled corruption without touching the file, and a
    recorder of a rank other than 0 (``deaths_only``) writes only when
    its process dies (a signal or a ``death:`` dump)."""
    from repro_torch.train import checkpoint as ckpt

    step_dir = tmp_path / "step_00000004"
    step_dir.mkdir()
    (step_dir / "arrays.npz").write_bytes(bytes(range(256)) * 4)
    plan = FaultPlan.single("ckpt_corrupt", 4)
    other, writer = FaultInjector(plan), FaultInjector(plan)
    assert other.corrupt_checkpoint(str(tmp_path), 4, write=False) is None
    assert (step_dir / "arrays.npz").read_bytes() == bytes(range(256)) * 4
    assert other.fired_total == 1
    assert writer.corrupt_checkpoint(str(tmp_path), 4) is not None
    assert (step_dir / "arrays.npz").read_bytes() != bytes(range(256)) * 4
    ckpt.barrier(None)                   # stacked ranks: no process group

    rec = FlightRecorder(str(tmp_path / "bb.json.rank1"))
    rec.deaths_only = True
    assert rec._safe_dump("exception:FaultInjectionError") is None
    assert rec._safe_dump("watchdog") is None
    assert not (tmp_path / "bb.json.rank1").exists()
    assert rec._safe_dump("death:RetryBudgetExhausted") is not None
    assert json.loads((tmp_path / "bb.json.rank1").read_text())[
        "reason"] == "death:RetryBudgetExhausted"


def test_refund_undispatched_nonfinite_refires_after_rewind():
    plan = FaultPlan(specs=(FaultSpec(kind="nonfinite", step=6),
                            FaultSpec(kind="nonfinite", step=2),
                            FaultSpec(kind="stall", step=6,
                                      duration_s=0.0)))
    inj = FaultInjector(plan).bind(n_leaves=2)
    for s in range(8):                       # the prefetch made 0..7
        inj.grad_flag(s)
        inj._take("stall", s)
    assert inj.fired_total == 3
    assert inj.refund_undispatched(4) == 1   # nonfinite@6 only, not stall
    assert inj.grad_flag(2).tolist() == [0, 0]       # dispatched: spent
    assert inj.grad_flag(6).tolist() == [1, 1]       # the replay injects
    assert inj.refund_undispatched(8) == 0


def test_before_dispatch_covers_superstep_range():
    plan = FaultPlan(specs=(FaultSpec(kind="collective", step=21),
                            FaultSpec(kind="collective", step=25)))
    inj = FaultInjector(plan)
    inj.before_dispatch(16, 4)                     # covers 16..19: clean
    with pytest.raises(FaultInjectionError, match="step 21"):
        inj.before_dispatch(20, 4)
    inj.before_dispatch(20, 4)                     # one-shot: replay clean
    with pytest.raises(FaultInjectionError, match="step 25"):
        inj.before_dispatch(25)
    assert inj.fired_total == 2


def test_serve_tick_hook():
    """The decode-tick hook the serving slice will call: it raises before
    the tick (collective, nonfinite) or only sleeps."""
    inj = FaultInjector(FaultPlan(specs=(
        FaultSpec(kind="collective", step=1),
        FaultSpec(kind="nonfinite", step=2),
        FaultSpec(kind="straggler", step=3, duration_s=0.0))))
    inj.serve_tick(0)
    with pytest.raises(FaultInjectionError, match="decode tick 1"):
        inj.serve_tick(1)
    with pytest.raises(NonFiniteEscalation):
        inj.serve_tick(2)
    inj.serve_tick(3)
    assert inj.fired_total == 3


def test_health_rule_nonfinite_fires_on_new_trips():
    reg = MetricsRegistry(enabled=True)
    mon = HealthMonitor(reg)
    assert mon.evaluate() == []
    reg.counter("guard/nonfinite_trips").inc(2)
    evs = mon.evaluate()
    assert [(e.severity, e.rule, e.subject) for e in evs] == \
        [("critical", "nonfinite", "grads")]
    assert mon.evaluate() == []


def test_checkpoint_crc_detects_corruption_and_falls_back(guarded_fn, model,
                                                          tmp_path):
    _, plan = guarded_fn
    d = str(tmp_path / "ck")
    state = _fresh(model, plan)
    for step in (0, 1):
        ckpt.save(d, state._replace(step=step), dp_total=P_DATA,
                  opt_layout=ckpt.opt_layout_of(TCFG))
    assert ckpt.latest_valid_step(d) == 1
    path = FaultInjector(FaultPlan.single("ckpt_corrupt", 1)) \
        .corrupt_checkpoint(d, 1)
    assert path is not None and path.endswith("arrays.npz")
    assert not ckpt.verify_checkpoint(d, 1) and ckpt.verify_checkpoint(d, 0)
    assert ckpt.latest_valid_step(d) == 0
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, state, dp_total=P_DATA, step=1, verify=True)
    assert ckpt.restore(d, state, dp_total=P_DATA, step=0,
                        verify=True).step == 0


# --------------------------------------------------------------------------
# the guarded, injectable step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lowering", ["manual", "spmd"])
def test_guard_trip_preserves_state_bit_exact(model, lowering):
    """A NaN fault vector trips the guard: params, ZeRO-1 moments, EF
    residuals and the in-flight reduction stay bit-equal (the step counter
    advances); an all-zero vector is the uninjected step, bit for bit; the
    next clean step applies."""
    fn, plan = rt_pipeline.build_pipelined_step(
        model, TCFG, P_DATA, "cpu", staleness=1, lowering=lowering,
        guard=True, inject=True, telemetry=False)
    plain, _ = rt_pipeline.build_pipelined_step(
        model, TCFG, P_DATA, "cpu", staleness=1, lowering=lowering,
        guard=True, telemetry=False)
    state = rt_pipeline.attach_inflight(_fresh(model, plan), plan)
    n_leaves = len(tree_leaves(state.params))

    def step(fn_, state, i, flag):
        batch = synthetic_batch(DCFG, i)
        if flag is not None:
            batch[FAULT_KEY] = np.full((n_leaves,), flag, np.float32)
        return fn_(state, batch)

    state, _ = step(fn, state, 0, 0.0)          # warm: in-flight live
    idle, _ = step(fn, state, 1, 0.0)
    none, _ = step(plain, state, 1, None)
    _assert_leaves_equal(_state_leaves(idle), _state_leaves(none))
    _assert_leaves_equal(tree_leaves(idle.inflight), tree_leaves(none.inflight))
    for flag in (1.0, 2.0):                     # NaN, then Inf
        tripped, m = step(fn, state, 1, flag)
        assert float(m["nonfinite"]) == 1.0
        _assert_leaves_equal(_state_leaves(tripped), _state_leaves(state))
        _assert_leaves_equal(tree_leaves(tripped.inflight),
                             tree_leaves(state.inflight))
        assert tripped.step == state.step + 1
    clean, m = step(fn, tripped, 2, 0.0)
    assert float(m["nonfinite"]) == 0.0
    assert all(torch.isfinite(x).all() for x in tree_leaves(clean.params))


# --------------------------------------------------------------------------
# the driver matrix: nonfinite, straggler, stall, collective, sigterm
# --------------------------------------------------------------------------

def test_driver_nonfinite_skip_preserves_prefix(guarded_fn, model,
                                                clean_run):
    """A single poisoned step is skipped: the losses through it are the
    clean run's (the forward never sees the poison), and divergence starts
    only where the clean run applied the gradient the guard discarded."""
    fn, plan = guarded_fn
    obs = _obs_with_metrics()
    inj = FaultInjector(FaultPlan.single("nonfinite", 3))
    state, log = _drive(fn, plan, model, injector=inj, obs=obs)
    assert state.step == N
    clean = clean_run["losses"]
    assert list(log.losses[:4]) == clean[:4]
    assert list(log.losses[4:]) != clean[4:]
    assert all(np.isfinite(x) for x in log.losses)
    assert obs.metrics.counter("guard/nonfinite_trips").value == 1
    assert obs.metrics.counter("faults/injected_nonfinite").value == 1
    evs = obs.metrics.events_named("health/nonfinite")
    assert len(evs) == 1 and evs[0]["step"] == 3


def test_driver_nonfinite_escalates_to_bit_equal_rewind(
        guarded_fn, model, clean_run, tmp_path):
    """Consecutive trips rewind to the last good checkpoint; the replay
    runs clean, so the retired tail and the final state are the clean
    run's bit for bit."""
    fn, plan = guarded_fn
    obs = _obs_with_metrics()
    inj = FaultInjector(FaultPlan(
        specs=(FaultSpec(kind="nonfinite", step=4, repeat=2),)))
    rec_cfg = RecoveryConfig(max_consecutive_nonfinite=2,
                             backoff_base_s=0.001, backoff_max_s=0.005)
    state, log = _drive(fn, plan, model, injector=inj, obs=obs,
                        ckpt_dir=tmp_path / "ck", recovery=rec_cfg)
    assert state.step == N and log.restarts == 1
    _assert_leaves_equal(_state_leaves(state), clean_run["state"])
    assert list(log.losses[-4:]) == clean_run["losses"][4:]
    assert obs.metrics.counter("guard/nonfinite_trips").value == 2
    assert obs.metrics.counter("recovery/retries_nonfinite").value == 1
    assert obs.metrics.events_named("driver/restart")


def test_driver_collective_retry_and_budget_abort(guarded_fn, model,
                                                  clean_run, tmp_path):
    fn, plan = guarded_fn
    obs = _obs_with_metrics()
    inj = FaultInjector(FaultPlan.single("collective", 3))
    state, log = _drive(fn, plan, model, injector=inj, obs=obs,
                        ckpt_dir=tmp_path / "ok", recovery=FAST_RECOVERY)
    assert state.step == N and log.restarts == 1
    _assert_leaves_equal(_state_leaves(state), clean_run["state"])
    assert list(log.losses[-5:]) == clean_run["losses"][3:]
    assert obs.metrics.counter("recovery/retries_collective").value == 1
    # a spent budget: a clean abort AFTER the blackbox dump
    bb = tmp_path / "bb.json"
    obs2 = _obs_with_metrics(recorder_path=bb)
    zero = RecoveryConfig(budgets={"collective": 0, "default": 0},
                          backoff_base_s=0.001)
    with pytest.raises(RetryBudgetExhausted) as ei:
        _drive(fn, plan, model,
               injector=FaultInjector(FaultPlan.single("collective", 3)),
               obs=obs2, ckpt_dir=tmp_path / "abort", recovery=zero)
    assert isinstance(ei.value.__cause__, FaultInjectionError)
    doc = json.load(open(bb))
    assert doc["kind"] == "blackbox"
    assert doc["reason"] == "exception:FaultInjectionError"
    assert obs2.metrics.counter("recovery/aborts").value == 1


def test_driver_stall_bounded_timeout_recovers(guarded_fn, model, clean_run,
                                               tmp_path):
    """A stalled data pipeline trips the bounded wait instead of hanging
    the dispatch loop; the stall budget restores and the replay ends
    bit-equal. The stall must outlast the steps before it (the producer
    sleeps while they run) and the 0.4 s wait: 6 s, as the reference's,
    holds on a loaded host too; the sleeping producer is a daemon
    thread."""
    fn, plan = guarded_fn
    obs = _obs_with_metrics()
    inj = FaultInjector(FaultPlan.single("stall", 2, duration_s=6.0))
    state, log = _drive(fn, plan, model, injector=inj, obs=obs,
                        ckpt_dir=tmp_path / "ck", recovery=FAST_RECOVERY,
                        timeout_s=0.4)
    assert state.step == N and log.restarts == 1
    _assert_leaves_equal(_state_leaves(state), clean_run["state"])
    assert obs.metrics.counter("faults/injected_stall").value == 1
    assert obs.metrics.counter("recovery/retries_stall").value == 1


def test_driver_prefetch_thread_exception_propagates(guarded_fn, model,
                                                     clean_run, tmp_path):
    """A batch_fn crash in the prefetch thread surfaces on the driver as
    PrefetchStalled (its cause attached), lands in the blackbox notes and
    recovers on the stall budget, bit-equal."""
    fn, plan = guarded_fn
    bb = tmp_path / "bb.json"
    obs = _obs_with_metrics(recorder_path=bb)
    boom = {"armed": True}

    def flaky_batch(s):
        if s == 3 and boom.pop("armed", False):
            raise ValueError("synthetic pipeline crash")
        return synthetic_batch(DCFG, s)

    state, log = _drive(fn, plan, model, injector=FaultInjector(FaultPlan()),
                        obs=obs, ckpt_dir=tmp_path / "ck",
                        recovery=FAST_RECOVERY, batch_fn=flaky_batch)
    assert state.step == N and log.restarts == 1
    _assert_leaves_equal(_state_leaves(state), clean_run["state"])
    assert obs.metrics.counter("recovery/retries_stall").value == 1
    notes = [n for n in json.load(open(bb))["notes"]
             if "prefetch_error" in str(n)]
    assert notes and "ValueError" in json.dumps(notes)


def test_driver_straggler_injection_is_wall_time_only(guarded_fn, model,
                                                      clean_run):
    fn, plan = guarded_fn
    obs = _obs_with_metrics()
    inj = FaultInjector(FaultPlan.single("straggler", 5, duration_s=0.05))
    state, log = _drive(fn, plan, model, injector=inj, obs=obs)
    assert state.step == N
    assert list(log.losses) == clean_run["losses"]
    _assert_leaves_equal(_state_leaves(state), clean_run["state"])
    assert obs.metrics.counter("faults/injected_straggler").value == 1
    assert log.step_times[5] >= 0.05


def test_driver_sigterm_clean_abort_with_blackbox(guarded_fn, model,
                                                  tmp_path):
    """SIGTERM mid-run: the recorder's chained handler dumps the blackbox,
    then the previous handler aborts the run; the driver's recovery path
    (Exception only) does not swallow it."""
    fn, plan = guarded_fn
    bb = tmp_path / "bb.json"
    obs = _obs_with_metrics(recorder_path=bb)

    def die(signum, frame):
        raise KeyboardInterrupt("SIGTERM")

    prev = signal.signal(signal.SIGTERM, die)
    try:
        obs.recorder.install_signal_handlers(("SIGTERM",))
        with pytest.raises(KeyboardInterrupt):
            _drive(fn, plan, model,
                   injector=FaultInjector(FaultPlan.single("sigterm", 2)),
                   obs=obs, num_steps=4)
        assert json.load(open(bb))["reason"] == "signal:SIGTERM"
    finally:
        obs.recorder.uninstall_signal_handlers()
        signal.signal(signal.SIGTERM, prev)


# --------------------------------------------------------------------------
# the Trainer: a corrupt save, then the restore that must fall back
# --------------------------------------------------------------------------

def test_trainer_chaos_ckpt_corrupt_falls_back_and_completes(model,
                                                             tmp_path):
    plan = FaultPlan(specs=(FaultSpec(kind="ckpt_corrupt", step=4),
                            FaultSpec(kind="collective", step=5)))
    inj = FaultInjector(plan)
    obs = _obs_with_metrics()
    tr = Trainer(model, TCFG, DCFG, dp_total=P_DATA, device="cpu",
                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, obs=obs)
    log = tr.run_pipelined(N, staleness=0, superstep=1, depth=1, prefetch=1,
                           guard=True, injector=inj, recovery=FAST_RECOVERY)
    assert tr.state.step == N and log.restarts == 1
    m = obs.metrics
    assert m.counter("faults/injected_ckpt_corrupt").value == 1
    assert m.counter("faults/injected_collective").value == 1
    assert m.counter("recovery/ckpt_fallbacks").value == 1
    assert m.counter("recovery/retries_collective").value == 1
    fb = m.events_named("recovery/ckpt_fallback")
    assert fb and fb[0]["corrupt_step"] == 4 and fb[0]["step"] == 2
    # the same plan without faults: the same final params, bit for bit
    clean = Trainer(model, TCFG, DCFG, dp_total=P_DATA, device="cpu",
                    ckpt_dir=str(tmp_path / "clean"), ckpt_every=2)
    clean.run_pipelined(N, staleness=0, superstep=1, depth=1, prefetch=1,
                        guard=True, injector=FaultInjector(FaultPlan()),
                        recovery=FAST_RECOVERY)
    _assert_leaves_equal(tree_leaves(tr.state.params),
                         tree_leaves(clean.state.params))


# --------------------------------------------------------------------------
# the recovery timeline of the report
# --------------------------------------------------------------------------

def test_report_renders_recovery_timeline(tmp_path):
    from repro_torch.obs.report import load_metrics_jsonl, render

    reg = MetricsRegistry(enabled=True)
    reg.counter("faults/injected_nonfinite").inc()
    reg.counter("guard/nonfinite_trips").inc(2)
    reg.counter("recovery/retries_stall").inc()
    reg.event("faults/injected", fault="nonfinite", step=4)
    reg.event("health/nonfinite", severity="critical", subject="grads",
              step=4, message="non-finite grads: apply skipped")
    reg.event("recovery/retry", cls="stall", step=5, attempt=1,
              delay_s=0.01, error="PrefetchStalled")
    reg.event("recovery/ckpt_fallback", step=2, corrupt_step=4)
    path = reg.dump_jsonl(str(tmp_path / "m.jsonl"))
    out = render(path)
    assert "-- recovery timeline --" in out
    for needle in ("faults/injected", "health/nonfinite", "recovery/retry",
                   "recovery/ckpt_fallback", "guard/nonfinite_trips=2"):
        assert needle in out, needle
    with open(path, "a") as f:                 # a torn tail still renders
        f.write('{"kind": "event", "event": "recovery/retr')
    assert len(load_metrics_jsonl(path)["events"]) == 4


def test_run_lm_chaos_survives_and_reports(model, monkeypatch, capsys):
    """run_lm --chaos SEED on a tiny model on the CPU: the seeded plan
    (every recoverable class and the corrupt-then-restore pair) fires,
    the run completes through the guard and the supervisor, and the
    closing line counts what it survived; the checkpoints go to a
    temporary directory that is removed. Seed 4 of 30 steps restores
    only after the first save (step 10) and corrupts the second (20); a
    plan whose first restore comes before a valid checkpoint exists
    aborts with CheckpointCorrupt, as the reference's does."""
    from repro_torch.train import run_lm

    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    monkeypatch.setattr(run_lm, "lm_config", lambda fast: (cfg, DCFG))
    made = []
    mkdtemp = run_lm.tempfile.mkdtemp
    monkeypatch.setattr(run_lm.tempfile, "mkdtemp",
                        lambda **kw: made.append(mkdtemp(**kw)) or made[-1])
    log = run_lm.main(["--fast", "--steps", "30", "--chaos", "4",
                       "--superstep", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    plan = FaultPlan.chaos(4, 30, ckpt_every=10)
    assert ("chaos plan (seed 4): " + ", ".join(
        f"{s.kind}@{s.step}" for s in plan.specs)) in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("chaos recovery: survived"))
    assert f"survived {len(plan.specs)} injected fault(s)" in line
    assert f"restarts={log.restarts}" in line and log.restarts >= 1
    assert "recovery/ckpt_fallbacks=1" in line
    assert np.isfinite(log.losses).all()
    assert made and not any(__import__("os").path.exists(d) for d in made)
