"""The port's non-blocking runtime (``repro_torch.runtime``) against the
JAX package's pipelined step, and against the port's own synchronous
step.

The reference is ``repro.runtime.pipeline.build_pipelined_step`` forced
onto its stacked-replica lowering (``lowering="spmd"``) or its per-rank
one (``"manual"``, shard_map over a (4, 1) mesh) with ZeRO-1 off and the
same dp as the port; both start from the reference's weights and see the
same batches, and QSGD runs get the reference's own rounding bits through
``rand_fn`` (``_qsgd_rand_all`` of the step's key, which is also the
manual lowering's per-rank layout). Its per-bucket telemetry rows are
held to the port's as the executor tests hold them
(``tests/_telemetry_check.py``).

Tolerances on the three losses: rtol=1e-5 without QSGD; rtol=2e-4 with
QSGD, where an L2 scale summed in another order can move one entry by a
whole quantization level. Within the port (staleness 0 against the
synchronous step, superstep and driver against sequential steps, a
guard trip) the ops are the same and the results bit-equal.
"""
import ast
import dataclasses
from pathlib import Path

from _telemetry_check import assert_telemetry_close

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.comm.executor import _qsgd_rand_all
from repro.comm.plan import build_sync_plan as jax_build_plan
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.models.specs import param_specs as jax_param_specs
from repro.optim.optimizers import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.runtime import pipeline as jax_pipeline
from repro.train.state import TrainConfig as JaxTrainConfig
from repro.train.train_step import init_state as jax_init_state
from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime import driver as rt_driver
from repro_torch.runtime import pipeline as rt_pipeline
from repro_torch.runtime.faults import (FAULT_KEY, FaultInjector, FaultPlan,
                                        NonFiniteEscalation, RecoveryConfig)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import run_lm
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
P_DATA = 4
STEPS = 3
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=10)
KEY = jax.random.PRNGKey(0)


def _sync_kwargs(qsgd_bits):
    return dict(mode="sparcml", k_per_bucket=4, bucket_size=128,
                algorithm="dsar_split_allgather", qsgd_bits=qsgd_bits,
                qsgd_bucket=128, min_sparse_size=1024)


def _tcfg(qsgd_bits=4, mode="sparcml"):
    sync = (SyncConfig(**_sync_kwargs(qsgd_bits)) if mode == "sparcml"
            else SyncConfig(mode="dense"))
    return TrainConfig(sync=sync, optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       zero1=False)


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


def _batch(i):
    return synthetic_batch(DataConfig(**DATA), i)


def _reference_rand_fn(step):
    """The reference's QSGD bits of ``step`` (key fold_in(KEY, step))."""
    skey = jax.random.fold_in(KEY, step)

    def rand_fn(bucket_idx, n):
        bits = _qsgd_rand_all(skey, bucket_idx, 1, P_DATA, n // P_DATA)
        return torch.from_numpy(np.array(bits).reshape(-1))

    return rand_fn


def _state_leaves(state, inflight=True):
    out = (tree_leaves(state.params) + tree_leaves(state.opt)
           + tree_leaves(state.residuals))
    if inflight and state.inflight is not None:
        out += tree_leaves(state.inflight)
    return out


def _assert_states_equal(a, b, inflight=True):
    assert a.step == b.step
    la, lb = _state_leaves(a, inflight), _state_leaves(b, inflight)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _run(step_fn, state, n, start=0, rand=None):
    losses = []
    for i in range(start, start + n):
        state, m = step_fn(state, _batch(i), rand(i) if rand else None)
        losses.append(float(m["loss"]))
    return state, losses


# --------------------------------------------------------------------------
# against the JAX package's pipelined step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs():
    """(staleness, qsgd_bits, lowering) -> (params0, losses, lrs, telemetry
    rows of each step) of the reference's guarded pipelined step, built
    once each."""
    cache = {}

    def get(staleness, qsgd_bits, lowering="spmd"):
        key = (staleness, qsgd_bits, lowering)
        if key in cache:
            return cache[key]
        jmodel = jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                                param_dtype=jnp.float32))
        tcfg = JaxTrainConfig(
            sync=JaxSyncConfig(**_sync_kwargs(qsgd_bits), impl="ref"),
            optimizer=JaxOptimizerConfig(), schedule=JaxScheduleConfig(**SCHED),
            microbatches=2, zero1=False)
        mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
        with mesh:
            fn, _, plan = jax_pipeline.build_pipelined_step(
                jmodel, tcfg, mesh, staleness=staleness, lowering=lowering,
                donate=False, telemetry=True, guard=True)
            state, _ = jax_init_state(jmodel, tcfg, mesh)
            params0 = jax.tree.map(np.asarray, state.params)
            if staleness:
                state = jax_pipeline.attach_inflight(state, plan, mesh)
            losses, lrs, tels = [], [], []
            for i in range(STEPS):
                batch = jax.tree.map(jnp.asarray, jax_synthetic_batch(
                    JaxDataConfig(**DATA), i))
                state, m = fn(state, batch, jax.random.fold_in(KEY, i))
                losses.append(float(m["loss"]))
                lrs.append(float(m["lr"]))
                tels.append(jax.tree.map(np.asarray, m["telemetry"]))
                assert float(m["nonfinite"]) == 0.0
        cache[key] = params0, losses, lrs, tels
        return cache[key]

    return get


def _port_run(model, params0, staleness, qsgd_bits, lowering=None,
              telemetry=False):
    """STEPS guarded pipelined steps of the port from the reference's
    weights with its bits: (losses, lrs, telemetry rows, final state)."""
    tcfg = _tcfg(qsgd_bits)
    step, plan = rt_pipeline.build_pipelined_step(
        model, tcfg, P_DATA, "cpu", staleness=staleness, guard=True,
        lowering=lowering, telemetry=telemetry)
    assert plan.num_sparse_buckets > 0
    state = ts.init_state(model, tcfg, plan, "cpu",
                          params=params_from_jax(params0))
    if staleness:
        state = rt_pipeline.attach_inflight(state, plan)
    losses, lrs, tels = [], [], []
    for i in range(STEPS):
        state, m = step(state, _batch(i), _reference_rand_fn(i))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        tels.append(m.get("telemetry"))
        assert float(m["nonfinite"]) == 0.0
    assert (state.inflight is None) == (staleness == 0)
    return losses, lrs, tels, state


@pytest.mark.parametrize("staleness", [0, 1])
@pytest.mark.parametrize("qsgd_bits,rtol", [(None, 1e-5), (4, 2e-4)])
def test_pipelined_step_matches_jax(model, reference_runs, staleness,
                                    qsgd_bits, rtol):
    params0, ref_losses, ref_lrs, _ = reference_runs(staleness, qsgd_bits)
    losses, lrs, _, _ = _port_run(model, params0, staleness, qsgd_bits)
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol)
    np.testing.assert_allclose(lrs, ref_lrs, rtol=1e-6)


@pytest.mark.parametrize("staleness", [0, 1])
@pytest.mark.parametrize("qsgd_bits,rtol", [(None, 1e-5), (4, 2e-4)])
def test_pipelined_manual_step_matches_jax(model, reference_runs, staleness,
                                           qsgd_bits, rtol):
    """The per-rank pipelined step (StackedCollectives of 4 ranks) against
    the reference's manual lowering, and against the port's own stacked
    pipelined step."""
    params0, ref_losses, ref_lrs, _ = reference_runs(staleness, qsgd_bits,
                                                     "manual")
    losses, lrs, _, state = _port_run(model, params0, staleness, qsgd_bits,
                                      lowering="manual")
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol)
    np.testing.assert_allclose(lrs, ref_lrs, rtol=1e-6)
    spmd_losses, _, _, spmd_state = _port_run(model, params0, staleness,
                                              qsgd_bits)
    np.testing.assert_allclose(losses, spmd_losses, rtol=rtol)
    assert state.residuals.keys() == spmd_state.residuals.keys()


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
@pytest.mark.parametrize("qsgd_bits", [None, 4])
def test_pipelined_telemetry_matches_jax(model, reference_runs, lowering,
                                         qsgd_bits):
    """The rows the pipelined step returns (staleness 1), step by step,
    against the reference's ``metrics["telemetry"]``."""
    params0, _, _, ref_tels = reference_runs(1, qsgd_bits, lowering)
    _, _, tels, _ = _port_run(model, params0, 1, qsgd_bits, lowering,
                              telemetry=True)
    for got, want in zip(tels, ref_tels):
        assert all(row.shape == (4,) for row in got.values())
        assert_telemetry_close(got, want, qsgd_bits is not None)


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
def test_telemetry_leaves_the_run_bit_unchanged(model, lowering):
    """Telemetry on and off: the same losses and state, bit for bit; the
    superstep stacks the rows to (K, 4)."""
    tcfg, k = _tcfg(4), 3
    runs = {}
    for tel in (False, True):
        sup, plan = rt_pipeline.build_superstep(
            model, tcfg, P_DATA, "cpu", steps=k, guard=True,
            lowering=lowering, telemetry=tel)
        batches = {key: np.stack([_batch(i)[key] for i in range(k)])
                   for key in _batch(0)}
        runs[tel] = sup(_fresh_pipelined(model, tcfg, plan), batches,
                        [_reference_rand_fn(i) for i in range(k)])
    (a, ma), (b, mb) = runs[False], runs[True]
    assert "telemetry" not in ma
    assert ma["loss"].tolist() == mb["loss"].tolist()
    _assert_states_equal(a, b)
    rows = mb["telemetry"]
    assert set(rows) == {bk.name for bk in plan.buckets if bk.sparse}
    for row in rows.values():
        assert row.shape == (k, 4) and torch.isfinite(row).all()
        assert ((row[:, 2] > 0) & (row[:, 2] <= 1)).all()


def test_inflight_shapes_match_jax():
    jmodel = jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                            param_dtype=jnp.float32))
    pshapes = jax.eval_shape(jmodel.init, KEY)
    jplan = jax_build_plan(pshapes, jax_param_specs(pshapes, jmodel.cfg, None),
                           JaxSyncConfig(**_sync_kwargs(4)), P_DATA)
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))
    plan = ts.build_plan(model, _tcfg(4), P_DATA)
    want = {k: tuple(s.shape) for k, s in jplan.inflight_shapes().items()}
    assert plan.inflight_shapes() == want
    zeros = plan.init_inflight()
    assert {k: tuple(v.shape) for k, v in zeros.items()} == want
    assert all(v.dtype == torch.float32 and not v.any()
               for v in zeros.values())


# --------------------------------------------------------------------------
# within the port: the same ops give the same bits
# --------------------------------------------------------------------------

def _staleness0_matches_synchronous(model, guard, lowering):
    tcfg = _tcfg(4)
    sync_fn, plan = ts.build_train_step(model, tcfg, P_DATA, "cpu",
                                        lowering=lowering)
    pipe_fn, _ = rt_pipeline.build_pipelined_step(
        model, tcfg, P_DATA, "cpu", staleness=0, guard=guard,
        lowering=lowering)
    s0 = ts.init_state(model, tcfg, plan, "cpu")
    a, la = _run(sync_fn, s0, STEPS)
    b, lb = _run(pipe_fn, s0, STEPS)
    assert la == lb
    assert b.inflight is None
    _assert_states_equal(a, b)


@pytest.mark.parametrize("guard", [False, True])
def test_staleness0_matches_synchronous_bit_for_bit(model, guard):
    _staleness0_matches_synchronous(model, guard, "spmd")


@pytest.mark.parametrize("guard", [False, True])
def test_staleness0_manual_matches_synchronous_bit_for_bit(model, guard):
    """The per-rank lowering: staleness 0 is its synchronous step."""
    _staleness0_matches_synchronous(model, guard, "manual")


def _fresh_pipelined(model, tcfg, plan):
    return rt_pipeline.attach_inflight(
        ts.init_state(model, tcfg, plan, "cpu"), plan)


def test_superstep_matches_sequential_steps(model):
    tcfg, k = _tcfg(4), 3
    sup, plan = rt_pipeline.build_superstep(model, tcfg, P_DATA, "cpu",
                                            steps=k, guard=True)
    step, _ = rt_pipeline.build_pipelined_step(model, tcfg, P_DATA, "cpu",
                                               guard=True)
    s0 = _fresh_pipelined(model, tcfg, plan)
    batches = {key: np.stack([_batch(i)[key] for i in range(k)])
               for key in _batch(0)}
    a, ma = sup(s0, batches, [_reference_rand_fn(i) for i in range(k)])
    b, lb = _run(step, s0, k, rand=_reference_rand_fn)
    assert ma["loss"].shape == ma["nonfinite"].shape == (k,)
    assert ma["loss"].tolist() == lb
    _assert_states_equal(a, b)


@pytest.mark.parametrize("n,k,depth", [(8, 2, 2), (7, 3, 2), (5, 1, 3)])
def test_driver_matches_sequential_steps(model, n, k, depth):
    """The driver changes scheduling, never numerics: (7, 3) ends with a
    shorter unit, (5, 1) drives the plain step."""
    tcfg = _tcfg(4)
    build = (rt_pipeline.build_superstep if k > 1
             else rt_pipeline.build_pipelined_step)
    kw = dict(steps=k) if k > 1 else {}
    fn, plan = build(model, tcfg, P_DATA, "cpu", guard=True, **kw)
    step, _ = rt_pipeline.build_pipelined_step(model, tcfg, P_DATA, "cpu",
                                               guard=True)
    s0 = _fresh_pipelined(model, tcfg, plan)
    state, log = rt_driver.run_pipelined(
        fn, s0, start_step=0, num_steps=n, batch_fn=_batch,
        cfg=rt_driver.DriverConfig(depth=depth, prefetch=2,
                                   steps_per_unit=k))
    ref, ref_losses = _run(step, s0, n)
    assert log.losses == ref_losses
    assert len(log.step_times) == n and log.restarts == 0
    _assert_states_equal(state, ref)


def _poison_grads(monkeypatch, steps):
    """Make the grads of the given steps' first leaf NaN (rank_grads is
    looked up at call time, so the step sees the patched one)."""
    orig = ts.rank_grads
    calls = {"n": 0}

    def poisoned(*args):
        loss, leaves_r = orig(*args)
        if calls["n"] in steps:
            leaves_r = [leaves_r[0] * float("nan"), *leaves_r[1:]]
        calls["n"] += 1
        return loss, leaves_r

    monkeypatch.setattr(ts, "rank_grads", poisoned)


@pytest.mark.parametrize("staleness", [0, 1])
def test_guard_trip_leaves_state_bit_unchanged(model, monkeypatch,
                                               staleness):
    tcfg = _tcfg(4)
    step, plan = rt_pipeline.build_pipelined_step(
        model, tcfg, P_DATA, "cpu", staleness=staleness, guard=True)
    state = ts.init_state(model, tcfg, plan, "cpu")
    if staleness:
        state = rt_pipeline.attach_inflight(state, plan)
    state, _ = _run(step, state, 2)            # live residuals + in-flight
    _poison_grads(monkeypatch, {0})
    after, m = step(state, _batch(2))
    assert float(m["nonfinite"]) == 1.0
    assert after.step == state.step + 1
    _assert_states_equal(after._replace(step=state.step), state)
    # the next clean step runs again
    _, m = step(after, _batch(3))
    assert float(m["nonfinite"]) == 0.0


def test_driver_escalates_consecutive_nonfinite_steps(model, monkeypatch):
    tcfg = _tcfg(4)
    fn, plan = rt_pipeline.build_superstep(model, tcfg, P_DATA, "cpu",
                                           steps=2, guard=True)
    s0 = _fresh_pipelined(model, tcfg, plan)
    _poison_grads(monkeypatch, {1, 2, 3})
    log = rt_driver.DriverLog()
    with pytest.raises(NonFiniteEscalation, match="ending at step 3"):
        rt_driver.run_pipelined(
            fn, s0, start_step=0, num_steps=8, batch_fn=_batch, log=log,
            cfg=rt_driver.DriverConfig(steps_per_unit=2))
    assert len(log.losses) == 4


def test_valid_key_gates_the_first_apply(model):
    """After every attach the step applies at lr 0: params stay bit-equal,
    the optimizer's count still advances, the flag turns valid."""
    tcfg = _tcfg(4)
    step, plan = rt_pipeline.build_pipelined_step(model, tcfg, P_DATA, "cpu")
    s0 = ts.init_state(model, tcfg, plan, "cpu")
    for start in (0, 4):                       # fresh start, then a resume
        s0 = s0._replace(step=start, inflight=None)
        state = rt_pipeline.attach_inflight(s0, plan)
        assert float(state.inflight[rt_pipeline.VALID_KEY]) == 0.0
        s1, m = step(state, _batch(start))
        assert float(m["lr"]) == 0.0
        for a, b in zip(tree_leaves(s1.params), tree_leaves(s0.params)):
            assert torch.equal(a, b)
        assert int(s1.opt["count"]) == int(s0.opt["count"]) + 1
        assert float(s1.inflight[rt_pipeline.VALID_KEY]) == 1.0
        s2, m = step(s1, _batch(start + 1))
        assert float(m["lr"]) > 0.0
        assert not torch.equal(s2.params["embed"], s1.params["embed"])
        s0 = s2


def test_attach_inflight_keeps_live_buffers(model):
    tcfg = _tcfg(4)
    plan = ts.build_plan(model, tcfg, P_DATA)
    state = _fresh_pipelined(model, tcfg, plan)
    assert rt_pipeline.attach_inflight(state, plan) is state


# --------------------------------------------------------------------------
# the reference's options: what is not ported raises, the rest runs; bad
# arguments are refused
# --------------------------------------------------------------------------

def _unported_calls(model, tmp_path):
    """Each option of the reference's step, driver and checkpoint
    functions that an earlier slice of the port refused, as a call that
    checks what it gives now."""
    tcfg = _tcfg(4)
    zero1 = dataclasses.replace(tcfg, zero1=True)
    plan = ts.build_plan(model, tcfg, P_DATA)
    build = rt_pipeline.build_pipelined_step
    trainer = lambda: Trainer(model, tcfg, DataConfig(**DATA),
                              dp_total=P_DATA, device="cpu")

    def drive(**kw):
        step, plan_ = build(model, tcfg, P_DATA, "cpu", guard=True,
                            inject="injector" in kw)
        state, log = rt_driver.run_pipelined(
            step, _fresh_pipelined(model, tcfg, plan_), start_step=0,
            num_steps=2, batch_fn=_batch, **kw)
        assert state.step == 2 and len(log.losses) == 2

    def inject():
        step, _ = build(model, tcfg, P_DATA, "cpu", inject=True, guard=True)
        state = _fresh_pipelined(model, tcfg, plan)
        batch = {**_batch(0), FAULT_KEY: np.ones(
            len(tree_leaves(state.params)), np.float32)}
        _, m = step(state, batch)
        assert float(m["nonfinite"]) == 1.0

    def run_trainer(**kw):
        log = trainer().run_pipelined(2, superstep=1, **kw)
        assert len(log.losses) == 2

    def remesh():
        zplan = ts.build_plan(model, zero1, P_DATA)
        state = ts.init_state(model, zero1, zplan, "cpu")
        ckpt.save(str(tmp_path), state, dp_total=P_DATA)
        half = ts.init_state(model, zero1, ts.build_plan(model, zero1, 2),
                             "cpu")
        back = ckpt.restore(str(tmp_path), half, dp_total=2, remesh=True)
        assert back.opt["mu"]["embed"].shape[0] == 2

    def convert():
        zplan = ts.build_plan(model, zero1, P_DATA)
        state = ts.init_state(model, zero1, zplan, "cpu")
        out = ckpt.convert_opt_layout(state, zplan, "zero1_leaf",
                                      "zero_scattered")
        assert set(out.opt["mu"]) == {b.name for b in zplan.buckets}

    return {
        "lowering=emulated": lambda: rt_pipeline.build_superstep(
            model, tcfg, P_DATA, "cpu", lowering="emulated"),
        "inject": inject,
        "driver recovery": lambda: drive(recovery=RecoveryConfig()),
        "driver injector": lambda: drive(injector=FaultInjector(
            FaultPlan()).bind(n_leaves=len(tree_leaves(
                ts.init_state(model, tcfg, plan, "cpu").params)))),
        "trainer injector": lambda: run_trainer(
            injector=FaultInjector(FaultPlan())),
        "trainer recovery": lambda: run_trainer(recovery=RecoveryConfig()),
        "restore remesh": remesh,
        "convert_opt_layout": convert,
    }


UNPORTED = ["lowering=emulated", "inject", "driver recovery",
            "driver injector", "trainer injector", "trainer recovery",
            "restore remesh", "convert_opt_layout"]
# options of the reference the port still does not have
STILL_UNPORTED = ["lowering=emulated"]


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_options_raise_not_implemented(model, name, tmp_path):
    """The reference's options an earlier slice refused: the one still
    not ported raises, naming its ROADMAP item; the ZeRO layouts and the
    fault runtime (ported since) run."""
    calls = _unported_calls(model, tmp_path)
    assert sorted(calls) == sorted(UNPORTED)
    if name in STILL_UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            calls[name]()
    else:
        calls[name]()


def test_bad_arguments_are_refused(model):
    build = rt_pipeline.build_pipelined_step
    with pytest.raises(ValueError, match="bounded at 1"):
        build(model, _tcfg(4), P_DATA, "cpu", staleness=2)
    with pytest.raises(ValueError, match="sparcml"):
        build(model, _tcfg(mode="dense"), P_DATA, "cpu")
    with pytest.raises(ValueError, match="lowering must be one of"):
        build(model, _tcfg(4), P_DATA, "cpu", lowering="xla")
    with pytest.raises(ValueError, match="steps >= 1"):
        rt_pipeline.build_superstep(model, _tcfg(4), P_DATA, "cpu", steps=0)
    step, plan = build(model, _tcfg(4), P_DATA, "cpu")
    with pytest.raises(ValueError, match="attach_inflight"):
        step(ts.init_state(model, _tcfg(4), plan, "cpu"), _batch(0))
    with pytest.raises(ValueError, match=">= 1"):
        rt_driver.run_pipelined(step, None, start_step=0, num_steps=1,
                                batch_fn=_batch,
                                cfg=rt_driver.DriverConfig(depth=0))


def test_record_step_flags_a_straggler():
    log = rt_driver.DriverLog()
    for i in range(6):
        rt_driver.record_step(log, i, 1.0, 0.5, straggler_factor=3.0)
    rt_driver.record_step(log, 6, 10.0, 0.5, straggler_factor=3.0)
    assert log.straggler_events == [(6, 10.0, 1.0)]
    assert len(log.losses) == len(log.step_times) == 7


def test_prefetcher_surfaces_a_failing_batch_fn(model):
    def batch_fn(step):
        if step == 2:
            raise OSError("disk gone")
        return _batch(step)

    fn, plan = rt_pipeline.build_pipelined_step(model, _tcfg(4), P_DATA,
                                                "cpu")
    s0 = _fresh_pipelined(model, _tcfg(4), plan)
    with pytest.raises(rt_driver.PrefetchStalled, match="failed at step 2"):
        rt_driver.run_pipelined(fn, s0, start_step=0, num_steps=4,
                                batch_fn=batch_fn)


# --------------------------------------------------------------------------
# run_lm --pipeline
# --------------------------------------------------------------------------

def _example_flags():
    """{flag: keywords of its add_argument} in examples/train_lm_topk.py."""
    tree = ast.parse((ROOT / "examples" / "train_lm_topk.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("type", "default", "action")
                  and not isinstance(k.value, ast.Name)}
            if any(isinstance(k.value, ast.Name) for k in node.keywords
                   if k.arg == "type"):
                kw["type"] = next(k.value.id for k in node.keywords
                                  if k.arg == "type")
            out[node.args[0].value] = kw
    return out


def test_run_lm_flags_match_the_example():
    """--pipeline, --superstep, --ckpt-dir, the observability flags
    (--adapt, --trace, --metrics-out, --blackbox), --zero and --chaos as
    the example has them; the checkpoint directory has no default (the
    example's lies outside the checkout)."""
    example = _example_flags()
    actions = {a.option_strings[0]: a for a in run_lm.build_parser()._actions
               if a.option_strings}
    assert set(example) <= set(actions), set(example) - set(actions)
    for flag in ("--steps", "--fast", "--pipeline", "--superstep",
                 "--ckpt-dir", "--adapt", "--trace", "--metrics-out",
                 "--blackbox", "--zero", "--chaos"):
        want, got = example[flag], actions[flag]
        if want.get("action") == "store_true":
            assert got.const is True and got.default is False
        else:
            assert got.type.__name__ == want["type"]
            if flag != "--ckpt-dir":
                assert got.default == want["default"]
    assert actions["--ckpt-dir"].default is None


def test_run_lm_pipeline_trains_and_prints_the_overlap_win(
        monkeypatch, capsys, tmp_path):
    """run_lm --pipeline on a tiny model on the CPU: the synchronous
    probe, the pipelined run and the printed win; a second call resumes
    from its checkpoint."""
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    monkeypatch.setattr(run_lm, "lm_config",
                        lambda fast: (cfg, DataConfig(**DATA)))
    argv = ["--fast", "--steps", "12", "--pipeline", "--superstep", "2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    log = run_lm.main(argv)
    out = capsys.readouterr().out
    assert "starting at step 0 (resume=no)" in out
    assert "overlap win: sync" in out and "superstep=2, depth=2" in out
    assert len(log.losses) == 12 and np.isfinite(log.losses).all()
    assert ckpt.latest_step(str(tmp_path)) == 12
    log = run_lm.main(argv[:2] + ["14"] + argv[3:])
    out = capsys.readouterr().out
    assert "starting at step 12 (resume=yes)" in out
    assert len(log.losses) == 2


def test_run_lm_pipeline_manual_trains(monkeypatch, capsys):
    """run_lm --pipeline --lowering manual: the per-rank pipelined loop,
    which the same stacked ranks give the same losses as the stacked
    one's within rtol 2e-4."""
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    monkeypatch.setattr(run_lm, "lm_config",
                        lambda fast: (cfg, DataConfig(**DATA)))
    argv = ["--fast", "--steps", "10", "--pipeline", "--superstep", "2",
            "--device", "cpu"]
    manual = run_lm.main(argv + ["--lowering", "manual"])
    out = capsys.readouterr().out
    assert "overlap win: sync" in out and "done: step 10" in out
    stacked = run_lm.main(argv)
    assert len(manual.losses) == 10 and np.isfinite(manual.losses).all()
    np.testing.assert_allclose(manual.losses, stacked.losses, rtol=2e-4)
