"""The port's ZeRO optimizer-state layouts (``zero1``, the scattered output
mode, layout conversion, remesh) against the JAX package's
(``tests/test_zero.py``), and against the port's own replicated step.

The same inputs go to both packages: plans of the same configuration, the
same numpy moments and gradients, the reference's weights, batches and
QSGD bits. Tolerances:

* plan geometry, wire and param-allgather bytes, signatures, the output
  mode advice: equal (the same arithmetic);
* the ZeRO-1 update on the same inputs: moments bit for bit; params at
  the optimizer test's rtol 1e-6, atol 1e-7 (the bias corrections' powf
  is XLA's in one package and libm's in the other, one ulp apart);
* three training steps against the reference's: losses rtol 2e-4 (QSGD,
  as the runtime tests), params rtol 1e-3, atol 1e-4 (``test_zero.py``'s
  own scattered-vs-replicated tolerance);
* within the port: ZeRO-1 against the full layout, bit for bit (the
  reference's claim); scattered against replicated at ``test_zero.py``'s
  tolerances (losses rtol 1e-5, params rtol 1e-3, atol 1e-4), and bit
  for bit over the stacked ranks, where the scattered step clips and
  updates with the replicated step's ops; owner chunks against the
  replicated reduction's own columns, and layout conversions, exactly.

A gloo world of 2 processes runs the ZeRO-1 and scattered steps one rank
a process against ``StackedCollectives(2)``, bit for bit (one thread in
every process); it is given a time limit.
"""
import dataclasses
import os
import socket
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.comm.executor import _qsgd_rand_all
from repro.comm.plan import build_sync_plan as jax_build_plan
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.core.cost_model import NetworkParams as JaxNetworkParams
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.optim.optimizers import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.runtime import adapt as jax_adapt
from repro.train import checkpoint as jax_ckpt
from repro.train import train_step as jax_ts
from repro.train.state import TrainConfig as JaxTrainConfig
from repro_torch.comm import executor
from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                          StackedCollectives)
from repro_torch.comm.plan import build_sync_plan
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.cost_model import NetworkParams
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime import adapt
from repro_torch.runtime import pipeline as rt_pipeline
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig, TrainState
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

P_DATA = 4
STEPS = 3
KEY = jax.random.PRNGKey(0)
N, BUCKET, KPB = 8192, 128, 8
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=10)
SYNC = dict(mode="sparcml", k_per_bucket=4, bucket_size=BUCKET,
            algorithm="dsar_split_allgather", qsgd_bits=4, qsgd_bucket=128,
            min_sparse_size=1024)
ALGOS = ["ssar_balanced_split", "ssar_rearranged_rs", "dsar_split_allgather"]


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


def _tcfg(mode="replicated", zero1=True, **opt):
    return TrainConfig(sync=SyncConfig(**SYNC, output_mode=mode),
                       optimizer=OptimizerConfig(**opt),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       zero1=zero1)


def _jax_tcfg(mode="replicated", zero1=True):
    return JaxTrainConfig(
        sync=JaxSyncConfig(**SYNC, impl="ref", output_mode=mode),
        optimizer=JaxOptimizerConfig(), schedule=JaxScheduleConfig(**SCHED),
        microbatches=2, zero1=zero1)


def _batch(i):
    return synthetic_batch(DataConfig(**DATA), i)


def _reference_rand_fn(step):
    """The reference's QSGD bits of ``step`` (key fold_in(KEY, step))."""
    skey = jax.random.fold_in(KEY, step)

    def rand_fn(bucket_idx, n):
        bits = _qsgd_rand_all(skey, bucket_idx, 1, P_DATA, n // P_DATA)
        return torch.from_numpy(np.array(bits).reshape(-1))

    return rand_fn


def _leaves(state, fields=("params", "opt", "residuals")):
    return [x for f in fields for x in tree_leaves(getattr(state, f))]


def _assert_bit_equal(a, b, fields=("params", "opt", "residuals")):
    la, lb = _leaves(a, fields), _leaves(b, fields)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _run(model, tcfg, lowering="spmd", params=None, n=STEPS, start=0,
         state=None, rand=_reference_rand_fn):
    step, plan = ts.build_train_step(model, tcfg, P_DATA, "cpu",
                                     lowering=lowering)
    if state is None:
        state = ts.init_state(model, tcfg, plan, "cpu", params=params)
    losses = []
    for i in range(start, start + n):
        state, m = step(state, _batch(i), rand(i) if rand else None)
        losses.append(float(m["loss"]))
    return losses, state, plan


# --------------------------------------------------------------------------
# the plan: geometry, owned columns, wire and param-allgather bytes
# --------------------------------------------------------------------------

def _flat_plans(mode, algorithm, k=KPB, dp=8):
    kw = dict(mode="sparcml", k_per_bucket=k, bucket_size=BUCKET,
              algorithm=algorithm, min_sparse_size=1024,
              fusion_bucket_bytes=1 << 14, output_mode=mode)
    jplan = jax_build_plan({"a": jax.ShapeDtypeStruct((N,), jnp.float32)},
                           {"a": P()}, JaxSyncConfig(**kw), dp)
    plan = build_sync_plan({"a": torch.empty((N,), device="meta")},
                           {"a": ()}, SyncConfig(**kw), dp)
    sparse = {b.name: algorithm for b in plan.buckets if b.sparse}
    assert sparse
    return jplan.replan(algorithms=sparse), plan.replan(algorithms=sparse)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("mode", ["replicated", "scattered"])
def test_plan_geometry_and_bytes_match_reference(mode, algo):
    jplan, plan = _flat_plans(mode, algo)
    assert plan.scattered == jplan.scattered == (mode == "scattered")
    assert plan.signature() == jplan.signature()
    assert plan.describe() == jplan.describe()
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert plan.owned_cols(b) == jplan.owned_cols(jb)
        assert plan.owned_cols(b) * plan.dp_total == b.cols
    assert plan.scattered_shapes() == {
        k: tuple(s.shape) for k, s in jplan.scattered_shapes().items()}
    assert plan.inflight_shapes() == {
        k: tuple(s.shape) for k, s in jplan.inflight_shapes().items()}
    for agg in (False, True):
        assert plan.wire_bytes(aggregate=agg) == jplan.wire_bytes(
            aggregate=agg)
        assert plan.param_allgather_bytes(aggregate=agg) == \
            jplan.param_allgather_bytes(aggregate=agg)
    if mode == "scattered":
        assert plan.param_allgather_bytes() > 0
        assert plan.signature().startswith("out=scattered|")
        zeros = plan.init_inflight(ranks=1)
        assert all(v.shape[0] == 1 for v in zeros.values())
    else:
        assert plan.param_allgather_bytes() == 0.0


def test_replan_keeps_the_mode_and_the_advice_matches_reference():
    """A replan inherits the output mode (another mode raises: it changes
    the state layout). ``recommend_output_mode`` weighs each mode of the
    plan (its bucket algorithms kept) by the reference's cost model: the
    modeled times are the reference's ``plan_bucket_times`` plus the param
    allgather's exposed tail, and the advice follows the hysteresis rule.
    (The reference's trial re-runs the cost model on its default network,
    which the port does not carry; here the algorithms stay.)"""
    from repro.core.cost_model import plan_bucket_times, t_param_allgather
    from repro_torch import obs
    from repro_torch.obs.metrics import MetricsRegistry

    jplan, plan = _flat_plans("scattered", "ssar_balanced_split", k=1)
    algos = {b.name: "ssar_rearranged_rs" for b in plan.buckets if b.sparse}
    re = plan.replan(algorithms=algos)
    assert re.scattered and re.signature() == \
        jplan.replan(algorithms=algos).signature()
    with pytest.raises(ValueError, match="keeps the output_mode"):
        plan.replan(algorithms=algos, output_mode="replicated")
    advice = set()
    for jp, tp in (_flat_plans("replicated", "ssar_balanced_split", k=1),
                   (jplan, plan)):
        for overlap in (0.0, 1e-3):
            for alpha, bw in ((1e-5, 1e9), (1e-6, 1e11), (1e-4, 1e12)):
                jnet = JaxNetworkParams(alpha=alpha, link_bytes_per_s=bw)
                dens = {b.name: 50.0 for b in tp.buckets}
                reg = MetricsRegistry(enabled=True)
                c = adapt.AdaptiveController(
                    tp, NetworkParams(alpha=alpha, link_bytes_per_s=bw),
                    adapt.AdaptConfig(), p_pod=1,
                    obs=obs.Observability(metrics=reg))
                rec = c.recommend_output_mode(dens, overlap)
                want = {}
                for mode in ("replicated", "scattered"):
                    trial = dataclasses.replace(jp, output_mode=mode)
                    t = sum(plan_bucket_times(trial, 8, jnet,
                                              densities=dens))
                    if mode == "scattered":
                        t_ag = sum(t_param_allgather(8, b.n, jnet)
                                   for b in trial.buckets)
                        t += max(0.0, t_ag - overlap)
                    want[mode] = t
                (e,) = reg.events_named("adapt/mode_recommend")
                assert e["t_replicated_s"] == want["replicated"]
                assert e["t_scattered_s"] == want["scattered"]
                cur = tp.output_mode
                other = "scattered" if cur == "replicated" else "replicated"
                h = adapt.AdaptConfig().hysteresis
                assert rec == (other if want[other] <= (1 - h) * want[cur]
                               else cur)
                advice.add((cur, rec))
    assert len(advice) > 1


# --------------------------------------------------------------------------
# ZeRO-1: the update against the reference's, and against the full layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_zero1_update_matches_reference(kind):
    """Three ZeRO-1 updates on the same params, grads and zero moments: a
    rowed leaf whose canonical layout moves its 'model' axis (a view of
    its memory) and a flat leaf padded to the bucket (a copy)."""
    rng = np.random.default_rng(len(kind))
    params = {"a": rng.standard_normal((3, 8, 256)).astype(np.float32),
              "b": rng.standard_normal(300).astype(np.float32)}
    grads = [{k: 3 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    sync = dict(mode="sparcml", bucket_size=BUCKET, k_per_bucket=4,
                algorithm="dsar_split_allgather", min_sparse_size=1024)
    # grad_clip huge: the reference's _zero1_update_spmd takes clipped
    # grads, the port's zero1_update clips them itself (by 1.0 here)
    jt = JaxTrainConfig(sync=JaxSyncConfig(**sync),
                        optimizer=JaxOptimizerConfig(kind=kind))
    tcfg = TrainConfig(sync=SyncConfig(**sync),
                       optimizer=OptimizerConfig(kind=kind, grad_clip=1e30))
    plan = build_sync_plan({k: torch.empty(v.shape, device="meta")
                            for k, v in params.items()},
                           {"a": (None, None, "model"), "b": ()}, tcfg.sync,
                           P_DATA)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = TrainState(tp, ts.init_opt(tp, tcfg, plan, "cpu"), None, 0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = {k: (jnp.zeros((), jnp.int32) if k == "count" else
                {n: jnp.zeros(v.shape) for n, v in m.items()})
            for k, m in state.opt.items()}
    for g in grads:
        jp, jopt = jax_ts._zero1_update_spmd(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jopt,
            jnp.float32(1e-2), jt, {"a": P(None, None, "model"), "b": P()},
            P_DATA)
        new_p, new_opt, _ = ts.zero1_update(
            state, [torch.from_numpy(g["a"]), torch.from_numpy(g["b"])],
            torch.tensor(1e-2), tcfg, plan)
        state = state._replace(params=new_p, opt=new_opt)
    assert int(state.opt["count"]) == 3
    for slot in ("mu", "nu") if kind == "adamw" else ("mu",):
        for name in params:
            np.testing.assert_array_equal(state.opt[slot][name].numpy(),
                                          np.asarray(jopt[slot][name]))
    for name in params:
        assert state.params[name].is_contiguous()
        np.testing.assert_allclose(state.params[name].numpy(),
                                   np.asarray(jp[name]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
def test_zero1_bit_equal_to_full_layout(model, lowering):
    """The reference's claim: ZeRO-1 gives the full update's values. Three
    steps (clipping binds: the grad norms are several times grad_clip)."""
    lf, sf, _ = _run(model, _tcfg(zero1=False), lowering)
    lz, sz, plan = _run(model, _tcfg(), lowering)
    assert lf == lz
    _assert_bit_equal(sf, sz, ("params", "residuals"))
    for name, m in zip(tree_leaves(sf.params), tree_leaves(sz.opt["mu"])):
        assert m.shape[0] == P_DATA
    slot = {s.leaf_id: s for g in plan.groups for s in g.slots}
    for i, (full, chunks) in enumerate(zip(tree_leaves(sf.opt["mu"]),
                                           tree_leaves(sz.opt["mu"]))):
        want = ts._chunks(full, slot[i].spec, BUCKET, P_DATA)
        assert torch.equal(chunks, want)


# --------------------------------------------------------------------------
# training against the reference, and scattered against replicated
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs():
    """(mode, lowering) -> (params0, losses, final params as numpy) of
    the reference's ZeRO-1 step (scattered or replicated), 3 steps."""
    cache = {}

    def get(mode, lowering):
        key = (mode, lowering)
        if key in cache:
            return cache[key]
        broken = compat.partial_manual_collectives_broken
        if lowering == "spmd":
            compat.partial_manual_collectives_broken = lambda m, a: True
        try:
            jmodel = jax_build_model(JaxModelConfig(
                **TINY, dtype=jnp.float32, param_dtype=jnp.float32))
            tcfg = _jax_tcfg(mode)
            mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
            assert jax_ts.sparcml_uses_manual_collectives(mesh) == \
                (lowering == "manual")
            step_fn, _ = jax_ts.build_train_step(jmodel, tcfg, mesh)
            state, _ = jax_ts.init_state(jmodel, tcfg, mesh)
            params0 = jax.tree.map(np.asarray, state.params)
            losses = []
            with mesh:
                for i in range(STEPS):
                    batch = jax.tree.map(jnp.asarray, jax_synthetic_batch(
                        JaxDataConfig(**DATA), i))
                    state, m = step_fn(state, batch,
                                       jax.random.fold_in(KEY, i))
                    losses.append(float(m["loss"]))
            cache[key] = (params0, losses,
                          [np.asarray(x) for x in
                           jax.tree.leaves(state.params)])
        finally:
            compat.partial_manual_collectives_broken = broken
        return cache[key]

    return get


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
@pytest.mark.parametrize("mode", ["replicated", "scattered"])
def test_zero_layouts_match_reference(model, reference_runs, mode, lowering):
    params0, ref_losses, ref_params = reference_runs(mode, lowering)
    losses, state, _ = _run(model, _tcfg(mode), lowering,
                            params=params_from_jax(params0))
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    for got, want in zip(tree_leaves(state.params), ref_params):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
def test_scattered_matches_replicated(model, lowering):
    """The reference's tolerances; over the stacked ranks bit for bit."""
    lr_, sr, _ = _run(model, _tcfg(), lowering)
    ls_, ss, plan = _run(model, _tcfg("scattered"), lowering)
    np.testing.assert_allclose(ls_, lr_, rtol=1e-5)
    for a, b in zip(tree_leaves(sr.params), tree_leaves(ss.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-4)
    assert set(ss.opt["mu"]) == {b.name for b in plan.buckets}
    assert any(float(v.abs().sum()) > 0 for v in ss.residuals.values())
    if lowering == "spmd":
        assert ls_ == lr_
        _assert_bit_equal(sr, ss, ("params", "residuals"))


def _grads(seed, n=N, dp=8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((dp, n)).astype(np.float32))


@pytest.mark.parametrize("form,algo", [
    ("per_rank", "ssar_rearranged_rs"), ("per_rank", "ssar_balanced_split"),
    ("per_rank", "ssar_split_allgather"), ("per_rank", "dsar_split_allgather"),
    ("stacked", "dsar_split_allgather")])
def test_scattered_chunks_equal_replicated_columns(form, algo):
    """Each owner chunk equals its own columns of the replicated reduction
    exactly, with the same residual carry, over 2 EF steps; the DSAR
    buckets with 4-bit QSGD (the round trip on each shard)."""
    outs, res = {}, {}
    for mode in ("replicated", "scattered"):
        _, plan = _flat_plans(mode, algo)
        if algo == "dsar_split_allgather":
            plan = dataclasses.replace(plan, cfg=dataclasses.replace(
                plan.cfg, qsgd_bits=4, qsgd_bucket=BUCKET))
        r = plan.init_residuals()
        outs[mode] = []
        for step in range(2):
            rand = lambda i, n, s=step: torch.from_numpy(
                np.random.default_rng(s * 100 + i).integers(
                    0, 2**32, n, dtype=np.uint64).astype(np.uint32))
            if form == "stacked":
                red, r, _ = executor.reduce_buckets_spmd(
                    plan, [_grads(step)], r, p_data=8, rand_fn=rand)
            else:
                red, r, _ = executor.reduce_buckets(
                    plan, [_grads(step)], r, rand_fn=rand,
                    coll=StackedCollectives(8, device="cpu"))
                if mode == "replicated":
                    red = {k: v[0] for k, v in red.items()}
            outs[mode].append(red)
        res[mode] = r
    for full, chunks in zip(outs["replicated"], outs["scattered"]):
        for name, buf in full.items():
            ch = chunks[name]
            w = buf.shape[1] // 8
            assert ch.shape == (8, buf.shape[0], w)
            for rank in range(8):
                assert torch.equal(ch[rank], buf[:, rank * w:(rank + 1) * w])
    for name in res["replicated"]:
        assert torch.equal(res["replicated"][name], res["scattered"][name])


def test_shard_mass_conservation_under_caps():
    """Low-overlap grads make the balanced split's capacity clamp bind:
    replicas x the owner shards + the residuals still sum to the grads
    (the clamped mass lands in the owning rank's fold, never vanishes)."""
    _, plan = _flat_plans("scattered", "ssar_balanced_split")
    g = _grads(7)
    reduced, new_res, _ = executor.reduce_buckets(
        plan, [g], plan.init_residuals(),
        coll=StackedCollectives(8, device="cpu"))
    clamped = False
    for b in plan.buckets:
        seg = g[:, b.col_start:b.col_start + b.cols].double()
        exact = seg.sum(0)
        merged = reduced[b.name][:, 0].reshape(-1).double()
        r_sum = new_res[b.name][:, 0].double().sum(0)
        torch.testing.assert_close(8.0 * merged + r_sum, exact, rtol=1e-4,
                                   atol=1e-4)
        clamped |= not torch.allclose(8.0 * merged, exact, atol=1e-6)
    assert clamped, "the caps never bound: the test exercises nothing"


# --------------------------------------------------------------------------
# layout conversion, checkpoints across packages, remesh
# --------------------------------------------------------------------------

def test_convert_opt_layout_value_exact_and_matches_reference(model):
    """zero1_leaf -> zero_scattered -> zero1_leaf gives back every value;
    each direction equals the reference's conversion of the same numbers
    (its padding columns zero, as the leaf layout leaves them)."""
    tcfg = _tcfg()
    plan = ts.build_plan(model, tcfg, P_DATA)
    state = ts.init_state(model, tcfg, plan, "cpu")
    slot = {s.leaf_id: s for g in plan.groups for s in g.slots}
    # random moments, zero in every padding column (as training leaves
    # them)
    leaves_p = tree_leaves(state.params)
    opt = {"count": state.opt["count"]}
    rng = np.random.default_rng(0)
    for k in ("mu", "nu"):
        chunks = []
        for i, p in enumerate(leaves_p):
            full = torch.from_numpy(rng.standard_normal(p.shape).astype(
                np.float32))
            chunks.append(ts._chunks(full, slot[i].spec, BUCKET,
                                     P_DATA).contiguous())
        opt[k] = tree_unflatten(tree_flatten(state.opt[k])[1], chunks)
    state = state._replace(opt=opt)
    sc = ckpt.convert_opt_layout(state, plan, "zero1_leaf", "zero_scattered")
    back = ckpt.convert_opt_layout(sc, plan, "zero_scattered", "zero1_leaf")
    for a, b in zip(tree_leaves(state.opt), tree_leaves(back.opt)):
        assert torch.equal(a, b)
    jplan = jax_build_plan(
        jax.eval_shape(jax_build_model(JaxModelConfig(
            **TINY, dtype=jnp.float32, param_dtype=jnp.float32)).init, KEY),
        _jax_param_specs(), JaxSyncConfig(**SYNC), P_DATA)
    jstate = jax_ts.TrainState(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.params),
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.opt), None,
        jnp.zeros((), jnp.int32))
    jsc = jax_ckpt.convert_opt_layout(jstate, jplan, "zero1_leaf",
                                      "zero_scattered")
    for name, v in sc.opt["mu"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            jsc.opt["mu"][name]))
    with pytest.raises(ValueError, match="only"):
        ckpt.convert_opt_layout(state, plan, "full", "zero_scattered")


def _jax_param_specs():
    from repro.models.specs import param_specs

    jcfg = JaxModelConfig(**TINY, dtype=jnp.float32, param_dtype=jnp.float32)
    return param_specs(jax.eval_shape(jax_build_model(jcfg).init, KEY),
                       jcfg, None)


@pytest.mark.parametrize("mode", ["replicated", "scattered"])
def test_checkpoints_cross_packages(model, tmp_path, mode):
    """A checkpoint of the reference's default config (ZeRO-1, and its
    --zero scattered layout) restores in the port bit for bit, and the
    port's restores in the reference."""
    from repro.train.trainer import Trainer as JaxTrainer

    layout = {"replicated": "zero1_leaf", "scattered": "zero_scattered"}[mode]
    d = str(tmp_path / "jax")
    jtr = JaxTrainer(
        jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                       param_dtype=jnp.float32)),
        _jax_tcfg(mode), compat.make_mesh((P_DATA, 1), ("data", "model")),
        JaxDataConfig(**DATA), ckpt_dir=d, ckpt_every=100)
    jtr.run(2)
    assert jax_ckpt.load_meta(d)["opt_layout"] == layout
    tr = Trainer(model, _tcfg(mode), DataConfig(**DATA), dp_total=P_DATA,
                 device="cpu", ckpt_dir=d)
    assert tr.init_or_resume() == 2
    want = jax.tree_util.tree_leaves(jtr.state)
    got = [x for x in ckpt._flatten_with_paths(tr.state)[1]
           if x is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g, np.int32) if isinstance(g, int) else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
    d2 = str(tmp_path / "port")
    ckpt.save(d2, tr.state, dp_total=P_DATA, opt_layout=layout)
    back = jax_ckpt.restore(d2, jtr.state, dp_total=P_DATA, verify=True)
    for g, w in zip(jax.tree_util.tree_leaves(back), want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("direction", ["zero1_to_scattered",
                                       "scattered_to_zero1"])
def test_other_layout_checkpoint_continues_bit_equal(model, tmp_path,
                                                     direction):
    """Two steps under one layout, a checkpoint, a Trainer of the other
    layout resumed from it (the moments converted, value-exact) and two
    more steps: the uninterrupted run of the target layout, bit for bit
    (over the stacked ranks the two layouts train alike)."""
    src, dst = (("replicated", "scattered") if direction ==
                "zero1_to_scattered" else ("scattered", "replicated"))
    d = str(tmp_path)
    bits = lambda s: _reference_rand_fn(s)
    tr = Trainer(model, _tcfg(src), DataConfig(**DATA), dp_total=P_DATA,
                 device="cpu", ckpt_dir=d, ckpt_every=100)
    tr.init()
    tr.run(2, rand_fn_for_step=bits)
    tr2 = Trainer(model, _tcfg(dst), DataConfig(**DATA), dp_total=P_DATA,
                  device="cpu", ckpt_dir=d, ckpt_every=100)
    assert tr2.init_or_resume() == 2
    conv = ckpt.convert_opt_layout(
        tr.state, tr2.plan, ckpt.opt_layout_of(tr.tcfg),
        ckpt.opt_layout_of(tr2.tcfg))
    for a, b in zip(tree_leaves(conv.opt), tree_leaves(tr2.state.opt)):
        assert torch.equal(a, b)
    tr2.run(4, rand_fn_for_step=bits)
    ref = Trainer(model, _tcfg(dst), DataConfig(**DATA), dp_total=P_DATA,
                  device="cpu")
    ref.init()
    ref.run(4, rand_fn_for_step=bits)
    _assert_bit_equal(tr2.state, ref.state)


def test_remesh_dp4_to_dp2(model, tmp_path):
    """An elastic restart from 4 replicas to 2: the ZeRO-1 chunks are
    re-split (the reference's ``_rechunk`` of the same arrays), the EF
    residuals restart at zero, and training goes on."""
    d = str(tmp_path)
    tr = Trainer(model, _tcfg(), DataConfig(**DATA), dp_total=P_DATA,
                 device="cpu", ckpt_dir=d, ckpt_every=100)
    tr.init()
    tr.run(2)
    saved = [m.clone() for m in tree_leaves(tr.state.opt["mu"])]
    assert tr.resume_elastic(2) == 2
    assert tr.dp_total == 2 and tr.plan.dp_total == 2
    for i, m in enumerate(tree_leaves(tr.state.opt["mu"])):
        want = jax_ckpt._rechunk(saved[i].numpy(), tuple(m.shape), P_DATA, 2)
        np.testing.assert_array_equal(m.numpy(), want)
        assert m.shape[0] == 2
        assert torch.equal(torch.cat(list(m), 1),
                           torch.cat(list(saved[i]), 1))
    assert all(not v.any() for v in tr.state.residuals.values())
    log = tr.run(4)
    assert tr.state.step == 4 and np.isfinite(log.losses).all()


# --------------------------------------------------------------------------
# the pipelined scattered step: one param allgather a bucket
# --------------------------------------------------------------------------

class _Counting(StackedCollectives):
    """StackedCollectives counting its all_gathers."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gathers = 0

    def all_gather(self, x, *, axis):
        self.gathers += 1
        return super().all_gather(x, axis=axis)


def test_pipelined_scattered_allgather_is_per_bucket(model):
    """On the per-rank path the scattered pipelined step makes exactly
    ONE all_gather a fusion bucket (the dense param allgather) and none
    on the gradient side: fewer than the replicated ZeRO-1 step, whose
    DSAR gathers and per-leaf param gathers both run."""
    counts = {}
    for mode in ("scattered", "replicated"):
        tcfg = _tcfg(mode)
        coll = _Counting(P_DATA, device="cpu")
        step, plan = rt_pipeline.build_pipelined_step(
            model, tcfg, P_DATA, "cpu", lowering="manual", coll=coll,
            telemetry=False, guard=True)
        state = rt_pipeline.attach_inflight(
            ts.init_state(model, tcfg, plan, "cpu"), plan)
        state, _ = step(state, _batch(0))
        coll.gathers = 0
        step(state, _batch(1))
        counts[mode] = coll.gathers
    assert counts["scattered"] == plan.num_buckets
    assert plan.num_buckets < plan.num_leaves
    assert counts["scattered"] < counts["replicated"]


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
def test_pipelined_scattered_staleness0_is_the_synchronous_step(model,
                                                                lowering):
    tcfg = _tcfg("scattered")
    ls, ss, plan = _run(model, tcfg, lowering, rand=None)
    step, _ = rt_pipeline.build_pipelined_step(
        model, tcfg, P_DATA, "cpu", staleness=0, guard=True,
        lowering=lowering)
    state = ts.init_state(model, tcfg, plan, "cpu")
    lp = []
    for i in range(STEPS):
        state, m = step(state, _batch(i))
        lp.append(float(m["loss"]))
    assert lp == ls
    _assert_bit_equal(state, ss)


# --------------------------------------------------------------------------
# one rank a process: a gloo world of 2 against the stacked ranks
# --------------------------------------------------------------------------

WORLD = 2
WORLD_TIMEOUT_S = 240


def _world_cases(coll):
    """ZeRO-1 (synchronous) and scattered (synchronous and pipelined)
    steps over ``coll``: {case: (params, moments and residuals with the
    held ranks leading, losses)}."""
    torch.manual_seed(0)
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))
    out = {}
    for case in ("zero1", "scattered", "scattered_pipelined"):
        tcfg = _tcfg("replicated" if case == "zero1" else "scattered")
        if case.endswith("pipelined"):
            step, plan = rt_pipeline.build_pipelined_step(
                model, tcfg, WORLD, "cpu", guard=True, lowering="manual",
                coll=coll, telemetry=False)
            state = rt_pipeline.attach_inflight(
                ts.init_state(model, tcfg, plan, "cpu", coll=coll), plan,
                coll.local_ranks)
        else:
            step, plan = ts.build_train_step(model, tcfg, WORLD, "cpu",
                                             lowering="manual", coll=coll)
            state = ts.init_state(model, tcfg, plan, "cpu", coll=coll)
        losses = []
        for i in range(STEPS):
            state, m = step(state, _batch(i))
            losses.append(m["loss"])
        held = [x for k in ("mu", "nu") for x in tree_leaves(state.opt[k])]
        held += tree_leaves(state.residuals)
        if state.inflight is not None:
            held += [v for k, v in sorted(state.inflight.items())
                     if k != rt_pipeline.VALID_KEY]
        out[case] = (tree_leaves(state.params), held, losses)
    return out


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        res = _world_cases(ProcessGroupCollectives(device="cpu"))
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_zero_layouts_one_rank_a_process_bit_equal_to_stacked():
    """Each process holds its 1/p of the moments (and of the scattered
    in-flight chunks); params and losses are the stacked run's, and each
    held chunk its rank's slice of the stacked state, bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_worker, args=(r, port, d))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(WORLD_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        if alive or any(p.exitcode for p in procs):
            pytest.fail(f"gloo world failed: exit codes "
                        f"{[p.exitcode for p in procs]}, "
                        f"{len(alive)} killed at the time limit")
        per_rank = [torch.load(os.path.join(d, f"rank{r}.pt"))
                    for r in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stacked = _world_cases(StackedCollectives(WORLD, device="cpu"))
    finally:
        torch.set_num_threads(threads)
    for case, (params, held, losses) in stacked.items():
        for r in range(WORLD):
            gp, gh, gl = per_rank[r][case]
            assert all(torch.equal(a, b) for a, b in zip(gp, params)), case
            assert [float(x) for x in gl] == [float(x) for x in losses]
            assert len(gh) == len(held)
            for got, want in zip(gh, held):
                assert got.shape[0] == 1 and want.shape[0] == WORLD, case
                assert torch.equal(got[0], want[r]), (case, r)


def test_run_lm_zero_trains_and_resumes_the_replicated_checkpoint(
        monkeypatch, capsys, tmp_path):
    """run_lm --zero on a tiny model on the CPU: the scattered plan, the
    synchronous and the pipelined loop; its checkpoints resume a run
    without --zero (zero_scattered -> zero1_leaf) and the reverse."""
    from repro_torch.train import run_lm

    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    monkeypatch.setattr(run_lm, "lm_config",
                        lambda fast: (cfg, DataConfig(**DATA)))
    base = ["--fast", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    log = run_lm.main(base + ["--steps", "4", "--zero"])
    out = capsys.readouterr().out
    assert "[scattered]" in out and "starting at step 0" in out
    assert len(log.losses) == 4 and np.isfinite(log.losses).all()
    assert ckpt.load_meta(str(tmp_path))["opt_layout"] == "zero_scattered"
    log = run_lm.main(base + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "starting at step 4 (resume=yes)" in out and "[scattered]" not in out
    assert ckpt.load_meta(str(tmp_path))["opt_layout"] == "zero1_leaf"
    log = run_lm.main(base + ["--steps", "20", "--zero", "--pipeline",
                              "--superstep", "2"])
    out = capsys.readouterr().out
    assert "starting at step 6 (resume=yes)" in out
    assert "overlap win" in out and np.isfinite(log.losses).all()
