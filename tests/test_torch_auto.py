"""``algorithm="auto"`` in the port against the JAX package's, on the CPU.

The reference resolves "auto" on its TPU constants ``DEFAULT_NET``; the
port has none, so each case here passes those values as ``net``
(``NetworkParams(1e-6, 50e9)``) and must get the reference's choices:

* every bucket of ``build_sync_plan`` and ``build_per_leaf_plan`` (its
  algorithm and whether it carries EF state, with the plan's geometry)
  at p in {2, 4, 8}, QSGD-4 on and off, the replicated and the
  scattered output mode, on the smoke LM (``run_lm --fast``'s lm-12m)
  and on the reference's regression shape (a 2^17 leaf at k = 256 of
  512); bit-equal, as plan geometry is;
* under two other networks, each bucket against the reference's
  ``select_bucket_algorithm`` given that network, some of them flipping;
* the regression shape's per-leaf sync: its bucket resolves to ``dense``
  and keeps its error feedback (the reference's
  ``test_sync_auto_dense_resolution_keeps_error_feedback``);
* the reference's default SparCML config (the algorithm left at "auto")
  through ``Trainer.run`` for 2 steps, both lowerings, against the
  reference's Trainer with its QSGD bits: losses and final params at
  the model parity tolerance (rtol 1e-5, a floor of 1e-5 of each
  tensor's largest magnitude);
* a checkpoint of an "auto" run resumed while the fit (patched) would
  select other algorithms: the saved plan comes back and the resumed run
  is bit-equal to the uninterrupted one.

Two threads, as the other CPU-heavy files pin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.comm.plan import build_per_leaf_plan as jax_per_leaf_plan
from repro.comm.plan import build_sync_plan as jax_sync_plan
from repro.core import topk as jax_topk
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.core.cost_model import NetworkParams as JaxNetworkParams
from repro.core.cost_model import select_bucket_algorithm as jax_select
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.models.specs import param_specs as jax_param_specs
from repro.optim.optimizers import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.train.state import TrainConfig as JaxTrainConfig
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.comm.collectives import StackedCollectives
from repro_torch.comm.plan import (BATCHED_ALGORITHMS, SPARSE_ALGORITHMS,
                                   build_per_leaf_plan, build_sync_plan)
from repro_torch.core import compressor
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.cost_model import NetworkParams
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, init_params
from repro_torch.models.specs import param_specs
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils import calibrate as cal
from test_torch_train import _reference_rand_fn

REF_NET = NetworkParams(1e-6, 50e9)       # the reference's DEFAULT_NET
LM12M = dict(name="lm-12m", family="dense", num_layers=4, d_model=256,
             num_heads=8, num_kv_heads=4, d_ff=512, vocab_size=2048,
             max_seq_len=256)
REGRESSION = 1 << 17                      # tests/test_compressor.py:113


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sync(shape: str, qsgd, out: str = "replicated", **kw) -> dict:
    base = (dict(k_per_bucket=256, bucket_size=512, min_sparse_size=65536)
            if shape == "regression" else
            dict(k_per_bucket=8, bucket_size=512, min_sparse_size=65536))
    return dict(mode="sparcml", algorithm="auto", qsgd_bits=qsgd,
                output_mode=out, **base, **kw)


def _trees(shape: str):
    """(JAX shapes, JAX specs, port shapes, port specs) of a shape."""
    if shape == "regression":
        jshapes = {"w": jax.ShapeDtypeStruct((REGRESSION,), jnp.float32)}
        shapes = {"w": torch.empty(REGRESSION, device="meta")}
        return jshapes, {"w": jax.sharding.PartitionSpec()}, shapes, {
            "w": ()}
    jcfg = JaxModelConfig(**LM12M, dtype=jnp.float32, param_dtype=jnp.float32)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    cfg = ModelConfig(**LM12M, dtype=torch.float32, param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    return (jshapes, jax_param_specs(jshapes, jcfg, None), shapes,
            param_specs(shapes, cfg))


def _buckets(plan) -> list:
    return [(g.gid, g.rows, g.cols, b.name, b.col_start, b.cols,
             b.algorithm, b.has_residual)
            for g in plan.groups for b in g.buckets]


@pytest.mark.parametrize("shape", ["lm12m", "regression"])
@pytest.mark.parametrize("out", ["replicated", "scattered"])
@pytest.mark.parametrize("qsgd", [None, 4])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_auto_plan_matches_reference(p, qsgd, out, shape):
    jshapes, jspecs, shapes, specs = _trees(shape)
    kw = _sync(shape, qsgd, out)
    jcfg, cfg = JaxSyncConfig(**kw), SyncConfig(**kw)
    for jbuild, build in ((jax_sync_plan, build_sync_plan),
                          (jax_per_leaf_plan, build_per_leaf_plan)):
        jplan = jbuild(jshapes, jspecs, jcfg, p)
        plan = build(shapes, specs, cfg, p, REF_NET)
        assert _buckets(plan) == _buckets(jplan)
        assert plan.num_sparse_buckets == jplan.num_sparse_buckets
        if any(b.n >= cfg.min_sparse_size for b in plan.buckets):
            with pytest.raises(ValueError, match="needs network parameters"):
                build(shapes, specs, cfg, p)
    if shape == "regression" and qsgd is None and p == 8:
        # the reference test's premise: auto resolves it to dense
        assert plan.buckets[0].algorithm == "dense"


@pytest.mark.parametrize("net", [(1e-3, 50e9), (1e-8, 1e9)])
def test_auto_under_another_network_matches_reference_selection(net):
    """Each bucket of the port's auto plans under ``net`` is the
    reference's ``select_bucket_algorithm`` given that network, and some
    of them differ from the reference's DEFAULT_NET choice."""
    flips = 0
    for shape in ("lm12m", "regression"):
        jshapes, jspecs, shapes, specs = _trees(shape)
        for p in (4, 8):
            for qsgd, k in ((None, None), (4, None), (None, 64)):
                kw = _sync(shape, qsgd)
                if k is not None:
                    kw["k_per_bucket"] = k
                cfg = SyncConfig(**kw)
                plan = build_sync_plan(shapes, specs, cfg, p,
                                       NetworkParams(*net))
                base = build_sync_plan(shapes, specs, cfg, p, REF_NET)
                for g in plan.groups:
                    for b in g.buckets:
                        if b.n < cfg.min_sparse_size:
                            assert b.algorithm == "dense"
                            continue
                        want = jax_select(
                            p, plan.bucket_k(g, b), b.n,
                            JaxNetworkParams(*net),
                            value_bits=qsgd or 32,
                            allow=(SPARSE_ALGORITHMS + ("dense",)
                                   if g.rows == 1 else BATCHED_ALGORITHMS))
                        assert b.algorithm == want, (shape, p, b.name)
                flips += sum(a != b for a, b in zip(
                    plan.algorithms().values(), base.algorithms().values()))
    assert flips > 0


def test_auto_dense_resolution_keeps_error_feedback():
    """The reference's regression: "auto" resolves the residual-bearing
    leaf's bucket to dense, and the per-leaf sync still compresses it
    with error feedback and sums the densified streams."""
    cfg = SyncConfig(mode="sparcml", k_per_bucket=256, bucket_size=512,
                     min_sparse_size=65536)
    shapes = {"w": torch.empty(REGRESSION, device="meta")}
    plan = build_per_leaf_plan(shapes, {"w": ()}, cfg, 8, REF_NET)
    assert plan.buckets[0].algorithm == "dense"
    res = compressor.init_residuals(shapes, {"w": ()}, cfg, 8)
    assert res["w"] is not None
    grads = np.random.default_rng(0).standard_normal(
        (8, REGRESSION)).astype(np.float32)
    out, new_res = compressor.sync_grads_inside(
        {"w": torch.from_numpy(grads)}, res, cfg, {"w": ()},
        coll=StackedCollectives(8, device="cpu"), net=REF_NET)
    dens = [np.asarray(jax_topk.compress2d(
        jnp.asarray(grads[r]).reshape(1, -1), 256, 512)[0].densify()
    ).reshape(-1) for r in range(8)]
    np.testing.assert_allclose(out["w"].numpy(), np.stack(dens).mean(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(new_res["w"].reshape(8, -1).numpy(),
                                  grads - np.stack(dens))


# --------------------------------------------------------------------------
# training with the reference's default config
# --------------------------------------------------------------------------

P_DATA = 4
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=1, total_steps=10)
# the reference's SyncConfig defaults but for sizes that make the tiny
# model's leaves sparse: the algorithm stays at its default, "auto"
DEFAULT_SPARCML = dict(mode="sparcml", k_per_bucket=4, bucket_size=128,
                       min_sparse_size=1024)


def _close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def reference_run():
    """The reference's Trainer, 2 steps of the default SparCML config on
    its stacked-replica path: (params0, losses, final params)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(compat, "partial_manual_collectives_broken",
               lambda mesh, axes: True)
    try:
        model = jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                               param_dtype=jnp.float32))
        tcfg = JaxTrainConfig(sync=JaxSyncConfig(**DEFAULT_SPARCML,
                                                 impl="ref"),
                              optimizer=JaxOptimizerConfig(),
                              schedule=JaxScheduleConfig(**SCHED),
                              microbatches=2, zero1=False)
        assert tcfg.sync.algorithm == "auto"
        mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
        trainer = JaxTrainer(model, tcfg, mesh, JaxDataConfig(**DATA))
        trainer.init_or_resume()
        params0 = jax.tree.map(np.asarray, trainer.state.params)
        with mesh:
            log = trainer.run(2)
        return (params0, list(log.losses),
                jax.tree.map(np.asarray, trainer.state.params))
    finally:
        mp.undo()


def _tcfg(**sync):
    return TrainConfig(sync=SyncConfig(**{**DEFAULT_SPARCML, **sync}),
                       optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       zero1=False)


def _model():
    return build_model(ModelConfig(**TINY, dtype=torch.float32,
                                   param_dtype=torch.float32))


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
def test_default_sync_config_trains_like_reference(reference_run, lowering):
    params0, ref_losses, ref_params = reference_run
    tcfg = _tcfg()
    assert tcfg.sync.algorithm == "auto"
    trainer = Trainer(_model(), tcfg, DataConfig(**DATA), dp_total=P_DATA,
                      device="cpu", lowering=lowering, net=REF_NET)
    assert trainer.plan.num_sparse_buckets > 0
    trainer.init(params=params_from_jax(params0))
    log = trainer.run(2, rand_fn_for_step=_reference_rand_fn)
    _close(np.asarray(log.losses), np.asarray(ref_losses))
    got = jax.tree_util.tree_leaves(
        {k: v for k, v in _numpy(trainer.state.params).items()})
    for g, w in zip(got, jax.tree_util.tree_leaves(ref_params)):
        _close(g, w)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_auto_resume_rebuilds_the_saved_plan(tmp_path, monkeypatch):
    """An "auto" run fitted on one network checkpoints; a fresh Trainer
    whose fit (patched) selects dense for every bucket resumes the saved
    plan (its residuals included) and runs on bit-equal to the
    uninterrupted run."""
    tcfg = _tcfg(k_per_bucket=32, qsgd_bits=4, qsgd_bucket=128)
    fits = [NetworkParams(1e-6, 50e9)]
    monkeypatch.setattr(cal, "calibrate", lambda coll, **kw: fits[-1])

    def trainer(ckpt_dir=None):
        return Trainer(_model(), tcfg, DataConfig(**DATA), dp_total=P_DATA,
                       device="cpu", ckpt_dir=ckpt_dir, ckpt_every=2)

    whole = trainer()
    whole.init_or_resume()
    whole.run(4)
    saved = trainer(str(tmp_path))
    saved.init_or_resume()
    saved.run(2)
    plan = saved.plan.algorithms()
    assert set(plan.values()) == {"dense", "dsar_split_allgather"}

    fits.append(NetworkParams(1e-3, 50e9))
    fresh = trainer()
    assert set(fresh.plan.algorithms().values()) == {"dense"}
    resumed = trainer(str(tmp_path))
    assert resumed.plan.algorithms() == plan
    assert resumed.init_or_resume() == 2
    resumed.run(4)
    assert resumed.log.losses == whole.log.losses[2:]
    for field in ("params", "residuals"):
        a = jax.tree_util.tree_leaves(_numpy(getattr(resumed.state, field)))
        b = jax.tree_util.tree_leaves(_numpy(getattr(whole.state, field)))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for k in ("mu", "nu"):
        for x, y in zip(jax.tree_util.tree_leaves(_numpy(
                resumed.state.opt[k])), jax.tree_util.tree_leaves(
                    _numpy(whole.state.opt[k]))):
            np.testing.assert_array_equal(x, y)


def test_elastic_resume_refits_for_the_new_ranks(tmp_path, monkeypatch):
    """resume_elastic selects again on a fit over the new rank count."""
    seen = []

    def fit(coll, **kw):
        seen.append(coll.p)
        return NetworkParams(1e-6, 50e9)

    monkeypatch.setattr(cal, "calibrate", fit)
    trainer = Trainer(_model(), _tcfg(), DataConfig(**DATA),
                      dp_total=P_DATA, device="cpu", ckpt_dir=str(tmp_path))
    trainer.init_or_resume()
    trainer.run(1)
    assert trainer.resume_elastic(2) == 1
    assert seen == [P_DATA, 2] and trainer.plan.dp_total == 2
    trainer.run(2)
    assert np.isfinite(trainer.log.losses).all()


def test_plan_from_auto_is_recorded_in_every_loop(tmp_path):
    """run and run_pipelined without adapt write the plan's algorithm map
    and its network when the plan came from "auto"."""
    from repro_torch.train import checkpoint as ckpt

    for loop in ("run", "run_pipelined"):
        d = tmp_path / loop
        trainer = Trainer(_model(), _tcfg(), DataConfig(**DATA),
                          dp_total=P_DATA, device="cpu", ckpt_dir=str(d),
                          net=REF_NET)
        trainer.init_or_resume()
        if loop == "run":
            trainer.run(1)
        else:
            trainer.run_pipelined(2, superstep=1, depth=1)
        meta = ckpt.load_meta(str(d))
        assert meta["plan_algorithms"] == trainer.plan.algorithms()
        assert meta["net"] == {"alpha": 1e-6, "link_bytes_per_s": 50e9,
                               "isize": 4}
    plain = Trainer(_model(), _tcfg(algorithm="dsar_split_allgather"),
                    DataConfig(**DATA), dp_total=P_DATA, device="cpu",
                    ckpt_dir=str(tmp_path / "named"))
    plain.init_or_resume()
    plain.run(1)
    assert "net" not in ckpt.load_meta(str(tmp_path / "named"))
