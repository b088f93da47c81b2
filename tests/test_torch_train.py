"""Three training steps of the port against the JAX package's train step.

Both start from the same weights (the reference's, through
``params_from_jax``) and see the same batches; sparcml runs get the
reference's own QSGD rounding bits through ``rand_fn``. The reference is
forced onto its stacked-replica (auto-SPMD) path, the form the port
takes, by making ``compat.partial_manual_collectives_broken`` say yes.

Tolerances on the three losses: rtol=1e-5 without QSGD; rtol=2e-4 with
QSGD, where an L2 scale summed in another order can move one entry by a
whole quantization level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.comm.executor import _qsgd_rand_all
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.optim.optimizers import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.train.state import TrainConfig as JaxTrainConfig
from repro.train.train_step import build_train_step as jax_build_train_step
from repro.train.train_step import init_state as jax_init_state
from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train import run_lm
from repro_torch.train.state import TrainConfig
from repro_torch.train.train_step import build_train_step
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_flatten

P_DATA = 4
STEPS = 3
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=10)


def _sync_kwargs(mode, qsgd_bits):
    return dict(mode=mode, k_per_bucket=4, bucket_size=128,
                algorithm="dsar_split_allgather", qsgd_bits=qsgd_bits,
                qsgd_bucket=128, min_sparse_size=1024)


def _reference_losses(mode, qsgd_bits, monkeypatch):
    if mode == "sparcml":
        monkeypatch.setattr(compat, "partial_manual_collectives_broken",
                            lambda mesh, axes: True)
    model = jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                           param_dtype=jnp.float32))
    tcfg = JaxTrainConfig(sync=JaxSyncConfig(**_sync_kwargs(mode, qsgd_bits),
                                             impl="ref"),
                          optimizer=JaxOptimizerConfig(),
                          schedule=JaxScheduleConfig(**SCHED),
                          microbatches=2, zero1=False)
    mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
    step_fn, _ = jax_build_train_step(model, tcfg, mesh)
    state, _ = jax_init_state(model, tcfg, mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    key = jax.random.PRNGKey(0)
    losses = []
    with mesh:
        for i in range(STEPS):
            batch = jax.tree.map(jnp.asarray, jax_synthetic_batch(
                JaxDataConfig(**DATA), i))
            state, m = step_fn(state, batch, jax.random.fold_in(key, i))
            losses.append(float(m["loss"]))
    return params0, losses


def _reference_rand_fn(step):
    """The reference's QSGD bits of ``step`` (same key as the run)."""
    skey = jax.random.fold_in(jax.random.PRNGKey(0), step)

    def rand_fn(bucket_idx, n):
        bits = _qsgd_rand_all(skey, bucket_idx, 1, P_DATA, n // P_DATA)
        return torch.from_numpy(np.array(bits).reshape(-1))

    return rand_fn


@pytest.mark.parametrize("mode,qsgd_bits,rtol", [
    ("dense", None, 1e-5),
    ("sparcml", None, 1e-5),
    ("sparcml", 4, 2e-4),
])
def test_three_step_losses_match_reference(mode, qsgd_bits, rtol,
                                           monkeypatch):
    params0, ref_losses = _reference_losses(mode, qsgd_bits, monkeypatch)
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))
    tcfg = TrainConfig(sync=SyncConfig(**_sync_kwargs(mode, qsgd_bits)),
                       optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       zero1=False)
    trainer = Trainer(model, tcfg, DataConfig(**DATA), dp_total=P_DATA,
                      device="cpu")
    if mode == "sparcml":
        assert trainer.plan.num_sparse_buckets > 0
    trainer.init(params=params_from_jax(params0))
    log = trainer.run(STEPS, rand_fn_for_step=_reference_rand_fn)
    np.testing.assert_allclose(log.losses, ref_losses, rtol=rtol)
    assert len(log.step_times) == STEPS


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_opt_update_matches_reference(kind):
    """Two optimizer updates (clip included) on a small tree."""
    from repro.optim.optimizers import init_opt_state as jax_init_opt
    from repro.optim.optimizers import opt_update as jax_opt_update
    from repro_torch.optim.optimizers import init_opt_state, opt_update

    rng = np.random.default_rng(len(kind))
    params = {"a": rng.standard_normal((8, 16)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = [{"a": 3 * rng.standard_normal((8, 16)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
             for _ in range(2)]
    jcfg, cfg = JaxOptimizerConfig(kind=kind), OptimizerConfig(kind=kind)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_init_opt(jp, jcfg)
    tp = params_from_jax(params)
    state = init_opt_state(tp, cfg)
    for g in grads:
        jp, jstate = jax_opt_update(jp, jax.tree.map(jnp.asarray, g), jstate,
                                    jnp.float32(1e-2), jcfg)
        tp, state = opt_update(tp, params_from_jax(g), state,
                               torch.tensor(1e-2), cfg)
    for a, b in zip(jax.tree.leaves(jp), [tp["a"], tp["b"]["c"]]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    assert int(state["count"]) == 2


@pytest.mark.parametrize("kind", ["cosine", "linear", "wsd", "constant"])
def test_schedule_matches_reference(kind):
    from repro.optim.schedule import make_schedule as jax_make_schedule
    from repro_torch.optim.schedule import make_schedule

    kw = dict(kind=kind, peak_lr=3e-4, warmup_steps=5, total_steps=40)
    jsched = jax_make_schedule(JaxScheduleConfig(**kw))
    sched = make_schedule(ScheduleConfig(**kw))
    for step in (0, 1, 4, 5, 17, 36, 39, 40, 55):
        assert float(sched(step)) == pytest.approx(float(jsched(step)),
                                                   rel=1e-6, abs=1e-12)


def test_sparcml_default_bits_come_from_a_seeded_generator():
    """Without rand_fn, a step draws its QSGD bits from a generator seeded
    by (seed, step): replaying a step reproduces it exactly."""
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))
    tcfg = TrainConfig(sync=SyncConfig(**_sync_kwargs("sparcml", 4)),
                       schedule=ScheduleConfig(**SCHED), microbatches=2)
    step_fn, plan = build_train_step(model, tcfg, P_DATA, device="cpu")
    from repro_torch.train.train_step import init_state

    state = init_state(model, tcfg, plan, device="cpu")
    batch = synthetic_batch(DataConfig(**DATA), 0)
    a, ma = step_fn(state, batch)
    b, mb = step_fn(state, batch)
    assert torch.isfinite(ma["loss"])
    for n in a.residuals:
        assert torch.equal(a.residuals[n], b.residuals[n])
    assert torch.equal(a.params["embed"], b.params["embed"])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))
    tcfg = TrainConfig(sync=SyncConfig(**_sync_kwargs("sparcml", 4)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, tcfg, DataConfig(**DATA))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_step(model, tcfg, P_DATA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_lm.main(["--fast", "--steps", "1"])


# examples/train_lm_topk.py's models and data, --fast and not
EXAMPLE_LMS = {
    "lm-12m": (dict(name="lm-12m", family="dense", num_layers=4, d_model=256,
                    num_heads=8, num_kv_heads=4, d_ff=512, vocab_size=2048,
                    max_seq_len=256),
               dict(global_batch=16, seq_len=128, vocab_size=2048)),
    "lm-100m": (dict(name="lm-100m", family="dense", num_layers=12,
                     d_model=768, num_heads=12, num_kv_heads=4, d_ff=2048,
                     vocab_size=32768, max_seq_len=1024),
                dict(global_batch=32, seq_len=512, vocab_size=32768)),
}


@pytest.mark.parametrize("name", list(EXAMPLE_LMS))
def test_run_lm_trains_the_examples_config(name):
    """run_lm's model, data and sync are the reference example's."""
    model_kw, data_kw = EXAMPLE_LMS[name]
    cfg, data = run_lm.lm_config(fast=name == "lm-12m")
    assert {k: getattr(cfg, k) for k in model_kw} == model_kw
    assert cfg.dtype == cfg.param_dtype == torch.float32
    assert (data.global_batch, data.seq_len, data.vocab_size) == (
        data_kw["global_batch"], data_kw["seq_len"], data_kw["vocab_size"])
    jcfg = JaxModelConfig(**model_kw, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    assert cfg.param_count() == jcfg.param_count()
    if name == "lm-100m":                # the weights, norms included
        meta = build_model(cfg).init(device="meta")
        assert sum(t.numel() for t in tree_flatten(meta)[0]) == 125_848_320
    tcfg = run_lm.train_config(300)
    s = tcfg.sync
    assert (s.mode, s.k_per_bucket, s.bucket_size, s.algorithm, s.qsgd_bits,
            s.min_sparse_size) == ("sparcml", 8, 512, "dsar_split_allgather",
                                   4, 65536)
    assert tcfg.microbatches == 2 and tcfg.optimizer.kind == "adamw"
    assert (tcfg.schedule.kind, tcfg.schedule.peak_lr,
            tcfg.schedule.warmup_steps, tcfg.schedule.total_steps) == (
                "wsd", 6e-4, 20, 300)


def test_model_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """Weights land on the card unless the caller asks for the CPU; shape
    only (meta) needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator().manual_seed(0))
    assert model.init(device="meta")["embed"].device.type == "meta"
    assert model.init(torch.Generator().manual_seed(0),
                      device="cpu")["embed"].device.type == "cpu"


# --------------------------------------------------------------------------
# the per-rank (manual) lowering of the synchronous step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qsgd_bits,rtol", [(None, 1e-5), (4, 2e-4)])
def test_manual_lowering_matches_spmd_and_reference(qsgd_bits, rtol,
                                                    monkeypatch):
    """Three steps through the per-rank executor over the stacked ranks
    (all_to_all split, owner densify, allgather, QSGD on the wire) against
    the stacked sum and against the reference, with its QSGD bits."""
    params0, ref_losses = _reference_losses("sparcml", qsgd_bits, monkeypatch)
    tcfg = TrainConfig(sync=SyncConfig(**_sync_kwargs("sparcml", qsgd_bits)),
                       optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       zero1=False)
    runs = {}
    for lowering in ("spmd", "manual"):
        model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                        param_dtype=torch.float32))
        trainer = Trainer(model, tcfg, DataConfig(**DATA), dp_total=P_DATA,
                          device="cpu", lowering=lowering)
        trainer.init(params=params_from_jax(params0))
        runs[lowering] = (trainer.run(STEPS, rand_fn_for_step=
                                      _reference_rand_fn).losses,
                          trainer.state)
    np.testing.assert_allclose(runs["manual"][0], runs["spmd"][0], rtol=rtol)
    np.testing.assert_allclose(runs["manual"][0], ref_losses, rtol=rtol)
    for n, r in runs["manual"][1].residuals.items():
        np.testing.assert_allclose(r.numpy(),
                                   runs["spmd"][1].residuals[n].numpy(),
                                   rtol=rtol, atol=1e-5)
    with pytest.raises(ValueError, match="lowering"):
        build_train_step(model, tcfg, P_DATA, device="cpu",
                         lowering="emulated")


# --------------------------------------------------------------------------
# sparse classification (examples/classify_sparse.py)
# --------------------------------------------------------------------------

def _example_loop(algo, idx, val, y, n_feat, steps):
    """examples/classify_sparse.py's loop, at the test's size."""
    from repro.core.allreduce import make_sparse_allreduce as jax_make

    mesh = compat.make_mesh((8,), ("data",))
    lr, bs, n_samples = 0.5, 16, idx.shape[0]

    def rank_grad(w, rank, step):
        lo = (step * 8 + rank) * bs % n_samples
        ii, vv, yy = idx[lo:lo + bs], val[lo:lo + bs], y[lo:lo + bs]
        m = (vv * w[ii]).sum(1)
        coef = (-yy / (1 + np.exp(yy * m)) / bs).astype(np.float32)
        g = np.zeros(n_feat, np.float32)
        np.add.at(g, ii.ravel(), (coef[:, None] * vv).ravel())
        return g

    f = jax_make(mesh, "data", n_feat, k_per_bucket=8, bucket_size=512,
                 algorithm=algo)
    w = np.zeros(n_feat, np.float32)
    for step in range(steps):
        grads = np.stack([rank_grad(w, r, step) for r in range(8)])
        summed = np.asarray(f(jnp.asarray(grads).reshape(-1), None))
        w -= lr * summed / 8
    return w


@pytest.mark.parametrize("algo", ["dense", "ssar_split_allgather"])
def test_classification_loop_matches_the_example(algo):
    from repro.data.sparse_datasets import make_url_like_dataset
    from repro_torch.train import run_classify as rc

    n_feat, n_samples, steps = 1 << 14, 256, 4
    idx, val, y = make_url_like_dataset(n_samples=n_samples,
                                        n_features=n_feat, nnz_per_sample=64)
    want = _example_loop(algo, idx, val, y, n_feat, steps)
    dev = torch.device("cpu")
    data = rc.load(dev, n_samples, n_feat, 64)
    for a, b in zip(data, (idx, val, y)):
        np.testing.assert_array_equal(a.numpy(), b)     # the same dataset
    w, _ = rc.train(algo, data, n_feat, dev, steps=steps)
    np.testing.assert_allclose(w.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    acc = rc.accuracy(w, data)
    m = (val * want[idx]).sum(1)
    assert acc == pytest.approx(float((np.sign(m) == y).mean()), abs=1e-2)


def test_new_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.train import run_classify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_classify.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_lm.main(["--fast", "--steps", "1", "--lowering", "manual"])
