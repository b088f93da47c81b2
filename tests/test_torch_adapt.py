"""The port's adaptive re-planning loop (``repro_torch.runtime.adapt``,
``SyncPlan.replan``, ``utils/calibrate.py``, the executors' EF-dense
branch) against the JAX package's.

The same inputs go to both packages: plans built from the same model and
sync configurations, the same measured densities and ``NetworkParams``,
the same synthetic telemetry streams. Plan signatures, controller
decisions and their events are held equal exactly (the cost model is the
same arithmetic in both); the least-squares fit to rtol 1e-12; losses of
a pipelined run with a forced swap at rtol 1e-5 (2e-4 with QSGD, where an
L2 scale summed in another order can move one entry by a level); the
EF-dense buckets' reduced buffers and residuals at the executor tests'
rtol 1e-5, atol 1e-6. No outcome here rests on a wall clock: the
calibration's timings are only checked to be finite, and the fit runs on
a fixed ladder.
"""
import dataclasses

from _telemetry_check import assert_telemetry_close

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro import obs as jax_obs
from repro.comm import executor as jax_exec
from repro.comm.executor import _qsgd_rand_all
from repro.comm.plan import build_sync_plan as jax_build_plan
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.core.cost_model import NetworkParams as JaxNetworkParams
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.models.specs import param_specs as jax_param_specs
from repro.obs.health import HealthEvent as JaxHealthEvent
from repro.optim.optimizers import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.runtime import adapt as jax_adapt
from repro.runtime import driver as jax_driver
from repro.runtime import pipeline as jax_pipeline
from repro.train import checkpoint as jax_ckpt
from repro.train.state import TrainConfig as JaxTrainConfig
from repro.train.train_step import init_state as jax_init_state
from repro.utils import calibrate as jax_calibrate
from repro_torch import obs
from repro_torch.comm import executor
from repro_torch.comm.collectives import StackedCollectives
from repro_torch.comm.plan import build_sync_plan
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.cost_model import NetworkParams
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, init_params
from repro_torch.models.specs import param_specs
from repro_torch.obs.health import HealthEvent
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime import adapt
from repro_torch.runtime import driver as rt_driver
from repro_torch.runtime import pipeline as rt_pipeline
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils import calibrate
from repro_torch.utils.tree import tree_flatten

P_DATA = 4
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
LM12M = dict(name="lm-12m", family="dense", num_layers=4, d_model=256,
             num_heads=8, num_kv_heads=4, d_ff=512, vocab_size=2048,
             max_seq_len=256)
LM100M = dict(name="lm-100m", family="dense", num_layers=12, d_model=768,
              num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
              max_seq_len=1024)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=20)
KEY = jax.random.PRNGKey(0)
NETS = [(1e-5, 1e9), (1e-6, 1e10), (1e-4, 1e11)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The models here are tiny: two threads do, and the other test
    workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nets(alpha, bw):
    return (JaxNetworkParams(alpha=alpha, link_bytes_per_s=bw),
            NetworkParams(alpha=alpha, link_bytes_per_s=bw))


def _plans(model_kw, dp=P_DATA, **sync_kw):
    """(reference plan, port plan) of one model and sync configuration."""
    jcfg = JaxModelConfig(**model_kw, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init, KEY)
    jplan = jax_build_plan(jshapes, jax_param_specs(jshapes, jcfg, None),
                           JaxSyncConfig(**sync_kw), dp)
    cfg = ModelConfig(**model_kw, dtype=torch.float32,
                      param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    plan = build_sync_plan(shapes, param_specs(shapes, cfg),
                           SyncConfig(**sync_kw), dp)
    assert plan.signature() == jplan.signature()
    return jplan, plan


def _sync(algorithm="dsar_split_allgather", k=8, b=512, qsgd_bits=4,
          min_sparse_size=1024):
    return dict(mode="sparcml", k_per_bucket=k, bucket_size=b,
                algorithm=algorithm, qsgd_bits=qsgd_bits,
                min_sparse_size=min_sparse_size)


def _cap(plan, g, b):
    return min(b.n, plan.dp_total * plan.bucket_k(g, b))


# --------------------------------------------------------------------------
# SyncPlan.replan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model_kw", [LM12M, LM100M], ids=["lm-12m",
                                                           "lm-100m"])
@pytest.mark.parametrize("algorithm", ["dsar_split_allgather",
                                       "ssar_recursive_double"])
def test_replan_signatures_match_jax(model_kw, algorithm):
    """The same measured densities on the same NetworkParams re-select the
    same algorithm for every bucket, with and without an allow set and
    pod-sparse flags; the geometry and layout stay the base plan's."""
    jplan, plan = _plans(model_kw, **_sync(algorithm, k=64,
                                           min_sparse_size=65536))
    rng = np.random.default_rng(len(plan.buckets))
    ef = [(g, b) for g in plan.groups for b in g.buckets if b.has_residual]
    fills = [{b.name: f * _cap(plan, g, b) for g, b in ef}
             for f in (0.02, 0.5, 1.0)]
    fills.append({b.name: float(rng.uniform(0, 1) * b.n) for g, b in ef})
    fills.append(None)
    for alpha, bw in NETS:
        jnet, net = _nets(alpha, bw)
        for dens in fills:
            for kw in ({}, {"allow": ("dsar_split_allgather", "dense")},
                       {"pod_sparse": {b.name: True for _, b in ef[:2]}}):
                got = plan.replan(dens, net, **kw)
                want = jplan.replan(dens, jnet, **kw)
                assert got.signature() == want.signature()
                assert got.algorithms() == want.algorithms()
                assert got.version == want.version == 1
                assert got.residual_shapes() == {
                    n: tuple(s.shape) for n, s in
                    want.residual_shapes().items()}
                assert got.inflight_shapes() == plan.inflight_shapes()


def test_replan_keeps_the_layout_and_refuses_what_is_not_ported():
    jplan, plan = _plans(TINY, **_sync(b=128, k=4))
    _, net = _nets(*NETS[0])
    demoted = plan.replan(algorithms={b.name: "dense" for b in plan.buckets})
    want = jplan.replan(algorithms={b.name: "dense" for b in jplan.buckets})
    assert demoted.signature() == want.signature()
    # every EF bucket keeps its residual; the raw-dense bucket stays one
    assert demoted.residual_shapes() == plan.residual_shapes()
    assert all(b.has_residual == (b.name in plan.residual_shapes())
               for b in demoted.buckets)
    assert {n: tuple(v.shape) for n, v in demoted.init_residuals().items()} \
        == plan.residual_shapes()
    again = demoted.replan(algorithms={b.name: "dsar_split_allgather"
                                       for b in plan.buckets})
    assert again.signature() == plan.signature() and again.version == 2
    # a replan keeps the output mode: another one changes the state layout
    assert plan.replan(algorithms={}, output_mode="replicated").output_mode \
        == "replicated"
    with pytest.raises(ValueError, match="keeps the output_mode"):
        plan.replan(algorithms={}, output_mode="scattered")
    with pytest.raises(ValueError, match="net"):
        plan.replan({b.name: 1.0 for b in plan.buckets})
    with pytest.raises(ValueError, match="output_mode"):
        plan.replan(algorithms={}, output_mode="sideways")
    # a batched bucket never leaves BATCHED_ALGORITHMS
    rowed = next(b for b in plan.buckets if b.rows > 1)
    bad = plan.replan(algorithms={rowed.name: "ssar_recursive_double"})
    assert bad.algorithms()[rowed.name] == "dsar_split_allgather"


# --------------------------------------------------------------------------
# the controller: the same telemetry stream gives the same decisions
# --------------------------------------------------------------------------

def _events(registry):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in registry.events]


def _drive_controllers(jplan, plan, net_kw, acfg_kw, stream, actions=()):
    """Feed ``stream`` (a list of per-step nnz dicts) to both packages'
    controllers; ``actions`` maps a step index to a callable run on each
    controller (with its package's HealthEvent) before that step. Returns
    the (reference, port) (signature-or-None sequence, events)."""
    jnet, net = _nets(*net_kw)
    out = []
    for pkg_plan, pkg_net, ctl_mod, obs_mod, ev_cls in (
            (jplan, jnet, jax_adapt, jax_obs, JaxHealthEvent),
            (plan, net, adapt, obs, HealthEvent)):
        ob = obs_mod.configure(metrics=True, set_as_default=False)
        ctl = ctl_mod.AdaptiveController(
            pkg_plan, pkg_net, ctl_mod.AdaptConfig(**acfg_kw), obs=ob)
        sigs = []
        for i, row in enumerate(stream):
            for when, act in actions:
                if when == i:
                    act(ctl, ev_cls)
            acc = ctl.observe_step(row)
            sigs.append(None if acc is None else acc.signature())
        out.append((sigs, _events(ob.metrics), ctl.plan.signature()))
    return out


def _stream(plan, fill, steps, wobble=0.0, seed=0):
    rng = np.random.default_rng(seed)
    ef = [(g, b) for g in plan.groups for b in g.buckets if b.has_residual]
    return [{b.name: float(fill(g, b) * (1 + wobble * rng.uniform(-1, 1)))
             for g, b in ef} for _ in range(steps)]


def _assert_same(runs, *must):
    (jsigs, jev, jplan), (sigs, ev, plan) = runs
    assert sigs == jsigs
    assert ev == jev
    assert plan == jplan
    names = {e["event"] for e in jev}
    assert set(must) <= names, names


def test_controller_patience_matches_jax():
    """A change that wins clearly is pending for one window and accepted
    after ``patience`` agreeing windows."""
    jplan, plan = _plans(LM12M, **_sync())
    stream = _stream(plan, lambda g, b: 0.3 * _cap(plan, g, b), 12, 0.05)
    runs = _drive_controllers(jplan, plan, NETS[0],
                              dict(window=2, patience=2), stream)
    _assert_same(runs, "adapt/replan_pending", "adapt/replan_accepted")
    assert sum(s is not None for s in runs[1][0]) == 1


def test_controller_hysteresis_veto_matches_jax():
    """A modeled win under the hysteresis margin is vetoed, bucket by
    bucket, with the costs that justified it."""
    jplan, plan = _plans(LM12M, **_sync())
    stream = _stream(plan, lambda g, b: 0.3 * _cap(plan, g, b), 8, 0.05)
    runs = _drive_controllers(
        jplan, plan, NETS[2],
        dict(window=2, patience=2, hysteresis=0.3,
             allow=("ssar_rearranged_rs", "dsar_split_allgather")), stream)
    _assert_same(runs, "adapt/hysteresis_veto")
    assert all(s is None for s in runs[1][0])


def test_controller_delta_forced_switch_matches_jax():
    """A measured fill-in over the delta threshold forces the SSAR bucket
    off its sparse representation, hysteresis or not."""
    jplan, plan = _plans(LM12M, **_sync("ssar_recursive_double", k=256))
    stream = _stream(plan, lambda g, b: 0.9 * b.n, 8, 0.02)
    runs = _drive_controllers(jplan, plan, NETS[0],
                              dict(window=2, patience=2, hysteresis=0.9),
                              stream)
    _assert_same(runs, "adapt/delta_forced", "adapt/replan_accepted")


def test_controller_health_advisory_and_fault_demotion_match_jax():
    """A critical health finding makes the next proposal urgent (accepted
    after one window); a fault demotion forces dense onto the named bucket
    and holds it there for ``demote_hold`` windows."""
    jplan, plan = _plans(LM12M, **_sync())
    stream = _stream(plan, lambda g, b: 0.3 * _cap(plan, g, b), 24, 0.05)

    def advise(ctl, ev):
        ctl.advise([ev("critical", "ef_growth", "g1b0", "grew", 5.0, 2.0),
                    ev("warn", "coverage_floor", "g2b0", "low", 0.4, 0.5)])

    def demote(ctl, ev):
        assert ctl.demote({"g3b0"}) is not None

    runs = _drive_controllers(jplan, plan, NETS[0],
                              dict(window=2, patience=3, demote_hold=2),
                              stream, actions=((1, advise), (8, demote)))
    _assert_same(runs, "adapt/health_advisory", "adapt/fault_demotion",
                 "adapt/forced_install", "adapt/replan_accepted")
    demoted = [e for e in runs[1][1] if e["event"] == "adapt/fault_demotion"]
    assert demoted[0]["buckets"] == ["g3b0"]
    assert "g3b0=dense" in demoted[0]["signature"]


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------

LADDER = ([4096 * 4, 16384 * 4, 65536 * 4, 262144 * 4, 1048576 * 4],
          [3.1e-5, 4.0e-5, 9.5e-5, 3.2e-4, 1.21e-3])


@pytest.mark.parametrize("p", [2, 4, 8])
def test_fit_network_params_matches_jax(p):
    got = calibrate.fit_network_params(*LADDER, p=p)
    want = jax_calibrate.fit_network_params(*LADDER, p=p)
    np.testing.assert_allclose([got.alpha, got.link_bytes_per_s],
                               [want.alpha, want.link_bytes_per_s],
                               rtol=1e-12)
    assert got.isize == want.isize


def test_degenerate_fit_raises():
    """Where the reference falls back to its TPU defaults, the port has
    none: a slope that is not positive, or one point, raises."""
    flat = ([1e3, 1e4, 1e5], [2e-3, 1.9e-3, 1.8e-3])
    with pytest.raises(calibrate.DegenerateFit):
        calibrate.fit_network_params(*flat, p=4)
    assert jax_calibrate.fit_network_params(*flat, p=4) == \
        jax_calibrate.DEFAULT_NET
    with pytest.raises(calibrate.DegenerateFit, match="2"):
        calibrate.fit_network_params([1e3], [1e-3], p=4)


def test_calibrate_records_the_ladder_residuals(monkeypatch):
    """The fit on a fixed ladder, and the post-fit residuals the auditor
    receives as ``dense_ladder`` samples, as the reference records them."""
    ladder = list(zip(*LADDER))
    monkeypatch.setattr(calibrate, "measure_allreduce_times",
                        lambda coll, sizes, repeats: ladder)
    aud = obs.DriftAuditor()
    net = calibrate.calibrate(StackedCollectives(4, device="cpu"),
                              auditor=aud)
    want = jax_calibrate.fit_network_params(*LADDER, p=4)
    np.testing.assert_allclose(net.link_bytes_per_s, want.link_bytes_per_s,
                               rtol=1e-12)
    assert [s["algorithm"] for s in aud.samples] == ["dense_ladder"] * 5
    assert [s["measured_s"] for s in aud.samples] == LADDER[1]
    assert all(s["kind"] == "calibration" and s["p"] == 4
               for s in aud.samples)


def test_measure_allreduce_times_on_the_stacked_ranks():
    """The ladder's shape on the CPU; its times are only checked to be
    finite and positive (the host clock decides nothing here)."""
    coll = StackedCollectives(4, device="cpu")
    meas = calibrate.measure_allreduce_times(coll, sizes=(1000, 4096),
                                             repeats=2)
    assert [b for b, _ in meas] == [1000 * 4, 4096 * 4]
    assert all(np.isfinite(t) and t > 0 for _, t in meas)


# --------------------------------------------------------------------------
# the executors' EF-dense branch
# --------------------------------------------------------------------------

def _tiny_grads(plan, seed):
    rng = np.random.default_rng(seed)
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    leaves, _ = tree_flatten(shapes)
    return [rng.standard_normal((P_DATA,) + tuple(l.shape)).astype(np.float32)
            for l in leaves]


@pytest.mark.parametrize("qsgd_bits", [None, 4])
def test_ef_dense_buckets_match_jax(qsgd_bits):
    """Every EF bucket but one demoted to dense: both executors of the
    port against the reference's stacked executor on the same grads,
    residuals and rounding bits; the demoted buckets keep their residual
    and draw no bits, and the stacked and per-rank forms are bit-equal."""
    jplan, plan = _plans(TINY, **_sync(b=128, k=4, qsgd_bits=qsgd_bits))
    keep = "g4b0"
    algos = {b.name: ("dsar_split_allgather" if b.name == keep else "dense")
             for b in plan.buckets if b.has_residual}
    jd, pd = jplan.replan(algorithms=algos), plan.replan(algorithms=algos)
    assert pd.signature() == jd.signature()
    grads = _tiny_grads(plan, 3)
    rng = np.random.default_rng(4)
    res = {n: rng.standard_normal(s).astype(np.float32)
           for n, s in pd.residual_shapes().items()}
    key = jax.random.PRNGKey(7)
    drawn = []

    def rand_fn(bucket_idx, n):
        drawn.append(bucket_idx)
        bits = _qsgd_rand_all(key, bucket_idx, 1, P_DATA, n // P_DATA)
        return torch.from_numpy(np.array(bits).reshape(-1))

    want_red, want_res, want_tel = jax_exec.reduce_buckets_spmd(
        jd, [jnp.asarray(g) for g in grads],
        {n: jnp.asarray(v) for n, v in res.items()}, key, p_data=P_DATA)
    t_grads = [torch.from_numpy(g) for g in grads]
    t_res = {n: torch.from_numpy(v) for n, v in res.items()}
    red, new_res, tel = executor.reduce_buckets_spmd(
        pd, t_grads, t_res, p_data=P_DATA, rand_fn=rand_fn)
    if qsgd_bits is not None:
        assert drawn == [[b.name for b in pd.buckets].index(keep)]
    for n in want_red:
        np.testing.assert_allclose(red[n].numpy(), np.asarray(want_red[n]),
                                   rtol=1e-5, atol=1e-6)
    for n in want_res:
        np.testing.assert_allclose(new_res[n].numpy(),
                                   np.asarray(want_res[n]),
                                   rtol=1e-5, atol=1e-6)
    want_tel = {n: np.asarray(v) for n, v in want_tel.items()}
    assert set(tel) == set(res)
    assert_telemetry_close(tel, want_tel, qsgd_bits is not None)
    coll = StackedCollectives(P_DATA, device="cpu")
    red_m, res_m, tel_m = executor.reduce_buckets(
        pd, t_grads, t_res, coll=coll, rand_fn=rand_fn)
    for n in red:
        assert torch.equal(red_m[n][0], red[n])
    for n in new_res:
        assert torch.equal(res_m[n], new_res[n])
    assert_telemetry_close({n: v[0] for n, v in tel_m.items()}, want_tel,
                           qsgd_bits is not None)


# --------------------------------------------------------------------------
# a pipelined run with a forced swap, against the JAX package's
# --------------------------------------------------------------------------

K_UNIT = 2
SWAP_AFTER = 2       # the unit ending at this step asks for the demotion
N_STEPS = 8


class _JaxDemoteAfter:
    """``adapt`` hook of the JAX package's driver: its runtime, plus a
    fault demotion of ``buckets`` (a critical ``nonfinite`` verdict naming
    them, the reference's path to a forced plan) handed to it after the
    retired unit that ends at ``step`` — what the port's
    ``AdaptiveRuntime.demote_after`` schedules; the driver installs the
    forced plan at its next drain barrier."""

    def __init__(self, rt, step, buckets):
        self.rt, self.step, self.buckets = rt, step, buckets

    def observe(self, first_step, n_steps, metrics):
        self.rt.observe(first_step, n_steps, metrics)
        if first_step + n_steps == self.step:
            self.rt.advise([JaxHealthEvent("critical", "nonfinite", b,
                                           "forced", 1.0, 0.0)
                            for b in self.buckets])

    def maybe_swap(self):
        return self.rt.maybe_swap()


def _tcfgs(qsgd_bits):
    kw = _sync(b=128, k=4, qsgd_bits=qsgd_bits)
    kw["qsgd_bucket"] = 128
    jtcfg = JaxTrainConfig(
        sync=JaxSyncConfig(**kw, impl="ref"), optimizer=JaxOptimizerConfig(),
        schedule=JaxScheduleConfig(**SCHED), microbatches=2, zero1=False)
    tcfg = TrainConfig(sync=SyncConfig(**kw), optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       zero1=False)
    return jtcfg, tcfg


def _reference_rand_fn(step):
    """The reference's QSGD bits of ``step`` (key fold_in(KEY, step))."""
    skey = jax.random.fold_in(KEY, step)

    def rand_fn(bucket_idx, n):
        bits = _qsgd_rand_all(skey, bucket_idx, 1, P_DATA, n // P_DATA)
        return torch.from_numpy(np.array(bits).reshape(-1))

    return rand_fn


def _jax_forced_swap_run(jtcfg, buckets):
    jmodel = jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                            param_dtype=jnp.float32))
    mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
    jnet, _ = _nets(*NETS[0])
    with mesh:
        _, _, plan = jax_pipeline.pipelined_state_shapes(jmodel, jtcfg, mesh)
        state, _ = jax_init_state(jmodel, jtcfg, mesh)
        params0 = jax.tree.map(np.asarray, state.params)
        state = jax_pipeline.attach_inflight(state, plan, mesh)
        rt = jax_adapt.AdaptiveRuntime(
            jmodel, jtcfg, mesh, plan=plan, net=jnet,
            cfg=jax_adapt.AdaptConfig(window=1000), superstep=K_UNIT,
            build_fn=lambda p: jax_pipeline.build_superstep(
                jmodel, jtcfg, mesh, steps=K_UNIT, plan=p, lowering="spmd",
                donate=False)[0])
        _, log = jax_driver.run_pipelined(
            rt.current_fn(), state, start_step=0, num_steps=N_STEPS,
            batch_fn=lambda s: jax_synthetic_batch(JaxDataConfig(**DATA), s),
            key_fn=lambda s: jax.random.fold_in(KEY, s),
            cfg=jax_driver.DriverConfig(steps_per_unit=K_UNIT),
            adapt=_JaxDemoteAfter(rt, SWAP_AFTER, buckets))
    return params0, list(log.losses), list(log.plan_swaps)


def _port_forced_swap_run(model, tcfg, params0, buckets, **rt_kw):
    plan = ts.build_plan(model, tcfg, P_DATA)
    _, net = _nets(*NETS[0])
    rt = adapt.AdaptiveRuntime(model, tcfg, P_DATA, "cpu", plan=plan,
                               net=net, cfg=adapt.AdaptConfig(window=1000),
                               superstep=K_UNIT, **rt_kw)
    rt.demote_after(SWAP_AFTER, buckets)
    state = rt_pipeline.attach_inflight(ts.init_state(
        model, tcfg, plan, "cpu", params=params_from_jax(params0)), plan)
    state, log = rt_driver.run_pipelined(
        rt.current_fn(), state, start_step=0, num_steps=N_STEPS,
        batch_fn=lambda s: synthetic_batch(DataConfig(**DATA), s),
        rand_fn_for_step=_reference_rand_fn,
        cfg=rt_driver.DriverConfig(steps_per_unit=K_UNIT),
        adapt=rt)
    return state, list(log.losses), list(log.plan_swaps), rt


@pytest.fixture(scope="module")
def model():
    return build_model(ModelConfig(**TINY, dtype=torch.float32,
                                   param_dtype=torch.float32))


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
@pytest.mark.parametrize("qsgd_bits,rtol", [(None, 1e-5), (4, 2e-4)])
def test_forced_swap_run_matches_jax(model, qsgd_bits, rtol, lowering):
    """g4b0 demoted to dense after step 2: both drivers drain and swap at
    step 4, with the same signature, and the losses agree; the port's
    per-rank executor gives the stacked one's losses."""
    jtcfg, tcfg = _tcfgs(qsgd_bits)
    params0, want, want_swaps = _jax_forced_swap_run(jtcfg, ["g4b0"])
    _, losses, swaps, rt = _port_forced_swap_run(
        model, tcfg, params0, ["g4b0"], lowering=lowering)
    assert swaps == want_swaps
    assert [s for s, _ in swaps] == [4]
    assert "g4b0=dense" in swaps[0][1]
    assert rt.current_plan.signature() == swaps[0][1]
    np.testing.assert_allclose(losses, want, rtol=rtol)


def test_forced_swap_equals_switching_by_hand(model):
    """The driver's swap at its drain barrier is the same run as building
    both plans' steps and switching between two driver calls there: the
    same losses and state, bit for bit (and the rounding bits of the other
    buckets do not move when one stops drawing)."""
    _, tcfg = _tcfgs(4)
    jtcfg, _ = _tcfgs(4)
    jmodel = jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                            param_dtype=jnp.float32))
    mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
    state0, _ = jax_init_state(jmodel, jtcfg, mesh)
    params0 = jax.tree.map(np.asarray, state0.params)
    state, losses, swaps, _ = _port_forced_swap_run(model, tcfg, params0,
                                                    ["g4b0", "g1b0"])
    plan = ts.build_plan(model, tcfg, P_DATA)
    demoted = plan.replan(algorithms={"g4b0": "dense", "g1b0": "dense"})
    assert swaps == [(4, demoted.signature())]
    s = rt_pipeline.attach_inflight(ts.init_state(
        model, tcfg, plan, "cpu", params=params_from_jax(params0)), plan)
    by_hand = []
    for p, lo, hi in ((plan, 0, 4), (demoted, 4, N_STEPS)):
        fn, _ = rt_pipeline.build_superstep(model, tcfg, P_DATA, "cpu",
                                            steps=K_UNIT, plan=p)
        s, log = rt_driver.run_pipelined(
            fn, s, start_step=lo, num_steps=hi,
            batch_fn=lambda i: synthetic_batch(DataConfig(**DATA), i),
            rand_fn_for_step=_reference_rand_fn,
            cfg=rt_driver.DriverConfig(steps_per_unit=K_UNIT))
        by_hand += log.losses
    assert losses == by_hand
    for f in ("params", "opt", "residuals", "inflight"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(state, f)),
                        jax.tree_util.tree_leaves(getattr(s, f))):
            assert torch.equal(a, b)


def test_replanned_plan_of_another_layout_is_refused(model):
    _, tcfg = _tcfgs(4)
    other = dataclasses.replace(tcfg, sync=SyncConfig(
        **{**_sync(b=256, k=4), "qsgd_bucket": 256}))
    with pytest.raises(ValueError, match="layout"):
        rt_pipeline.build_pipelined_step(
            model, tcfg, P_DATA, "cpu",
            plan=ts.build_plan(model, other, P_DATA))


# --------------------------------------------------------------------------
# checkpoints carry the active plan
# --------------------------------------------------------------------------

def test_jax_adaptive_checkpoint_resumes_the_plan(model, tmp_path):
    """A checkpoint the JAX package wrote under an adapted plan (its
    Trainer's meta: signature, version, algorithm map, pod flags) resumes
    in the port's adaptive Trainer on the same plan, and the port's own
    checkpoints carry it on."""
    from repro.train.trainer import Trainer as JaxTrainer

    d = str(tmp_path)
    jtcfg, tcfg = _tcfgs(4)
    jtr = JaxTrainer(
        jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                       param_dtype=jnp.float32)),
        jtcfg, compat.make_mesh((P_DATA, 1), ("data", "model")),
        JaxDataConfig(**DATA))
    jtr.run(2)
    jmesh = jtr.mesh
    _, _, jbase = jax_pipeline.pipelined_state_shapes(jtr.model, jtcfg, jmesh)
    jactive = jbase.replan(algorithms={"g3b0": "dense", "g4b0": "dense"})
    jax_ckpt.save(d, jtr.state, dp_total=P_DATA, opt_layout="full",
                  extra_meta={"plan_signature": jactive.signature(),
                              "plan_version": jactive.version,
                              "plan_algorithms": jactive.algorithms(),
                              "plan_pod_sparse": jactive.pod_sparse_flags()})
    tr = Trainer(model, tcfg, DataConfig(**DATA), dp_total=P_DATA,
                 device="cpu", ckpt_dir=d, ckpt_every=100)
    tr._net_cal = _nets(*NETS[0])[1]
    tr.run_pipelined(4, superstep=2, adapt=adapt.AdaptConfig(window=1000))
    assert tr.last_plan.signature() == jactive.signature()
    assert tr.last_adapt_runtime.current_plan.version == jactive.version
    meta = ckpt.load_meta(d)
    assert meta["step"] == 4
    assert meta["plan_signature"] == jactive.signature()
    assert meta["plan_algorithms"] == jactive.algorithms()
    assert meta["plan_version"] == 1
    # the JAX package resumes the port's checkpoint on the same plan
    assert jax_ckpt.load_meta(d)["plan_signature"] == jactive.signature()


def test_trainer_adapt_runs_swaps_and_records(model, tmp_path):
    """Trainer.run_pipelined(adapt=...) with observability on: telemetry
    histograms for every EF bucket, one sample a retired step, the
    controller's decisions and health verdicts, and no derived
    device-phase track in the trace."""
    _, tcfg = _tcfgs(4)
    ob = obs.configure(trace=True, metrics=True, audit=True,
                       set_as_default=False)
    tr = Trainer(model, tcfg, DataConfig(**DATA), dp_total=P_DATA,
                 device="cpu", obs=ob)
    tr._net_cal = _nets(*NETS[0])[1]
    tr.init()
    log = tr.run_pipelined(12, superstep=2, adapt=adapt.AdaptConfig(
        window=2, patience=1))
    assert len(log.losses) == 12 and np.isfinite(log.losses).all()
    assert log.losses is ob.metrics.series("train/loss").data
    ef = [b.name for b in tr.plan.buckets if b.has_residual]
    for n in ef:
        for col in ("nnz", "wire_bytes", "mass_coverage", "ef_norm"):
            assert len(ob.metrics.histogram(f"bucket/{n}/{col}").values) \
                == 12
    assert tr.last_health is not None and tr.last_health.history
    assert obs.validate_span_tree(ob.tracer.events) == []
    assert not [e for e in ob.tracer.events
                if e.get("tid") == "device-phases"]
    assert ob.metrics.histogram("driver/retire_wall_s").snapshot()[
        "count"] == 6
    assert tr.last_plan is tr.last_adapt_runtime.current_plan
    assert [e["event"] for e in ob.metrics.events_named(
        "driver/plan_swap")] == ["driver/plan_swap"] * len(log.plan_swaps)


def test_trainer_adapt_needs_network_parameters(model):
    _, tcfg = _tcfgs(4)
    tr = Trainer(model, tcfg, DataConfig(**DATA), dp_total=P_DATA,
                 device="cpu")
    with pytest.raises(ValueError, match="NetworkParams"):
        tr.run_pipelined(2, adapt=adapt.AdaptConfig(calibrate=False))
    with pytest.raises(ValueError, match="staleness"):
        tr.run_pipelined(2, staleness=0, adapt=True)
