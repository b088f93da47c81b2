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
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro import configs as jax_configs
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
from repro_torch import configs
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


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
# the MoE family: moonshot's smoke config under its own SparCML config
# --------------------------------------------------------------------------

MOONSHOT = "moonshot-v1-16b-a3b"
MOE_DATA = dict(global_batch=16, seq_len=16, vocab_size=512)
# three steps: the schedule's lr is 0 at step 0, so steps 1 and 2 are the
# ones that update the params
MOE_STEPS = 3


def _fixed_coefs(cfg_like) -> list:
    """One seeded coefficient array a leaf for the fixed-gradient loss:
    multiples of 2^-10 with at most 6 significant bits, so that a
    coefficient times the batch's factor (1..4) is exact in bf16."""
    rng = np.random.default_rng(11)
    return [(rng.integers(-63, 64, np.shape(a)) / 1024).astype(np.float32)
            for a in cfg_like]


def _fixed_loss_jax(coefs):
    """sum(p * c) times 1 + (the batch's first token mod 4): its gradient
    is c times that factor in each leaf's dtype, exact in both packages,
    and differs between the ranks' and the microbatches' rows."""
    cs = [jnp.asarray(c) for c in coefs]

    def loss(params, batch):
        s = 1.0 + (batch["tokens"][0, 0] % 4).astype(jnp.float32)
        return s * sum(jnp.sum(p.astype(jnp.float32) * c)
                       for p, c in zip(jax.tree.leaves(params), cs))
    return loss


def _fixed_loss_torch(coefs):
    cs = [torch.from_numpy(c) for c in coefs]

    def loss(params, batch):
        s = 1.0 + (batch["tokens"][0, 0] % 4).to(torch.float32)
        return s * sum((p.to(torch.float32) * c).sum()
                       for p, c in zip(tree_flatten(params)[0], cs))
    return loss


def _moe_reference(bf16: bool, monkeypatch, fixed_grads: bool = False):
    """The reference's SparCML steps of the moonshot smoke config (its
    train_config: DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1, 4 microbatches)
    on the stacked ranks: {params0, losses, params, mu, nu, residuals} as
    f32 numpy (leaves in tree order, residuals by bucket name).
    ``fixed_grads``: the model's loss is :func:`_fixed_loss_jax`."""
    monkeypatch.setattr(compat, "partial_manual_collectives_broken",
                        lambda mesh, axes: True)
    jcfg = jax_configs.smoke_config(MOONSHOT)
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16,
                                   param_dtype=jnp.bfloat16)
    mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
    tcfg = dataclasses.replace(jax_configs.get_train_config(MOONSHOT, mesh),
                               schedule=JaxScheduleConfig(**SCHED))
    model = jax_build_model(jcfg)
    state, _ = jax_init_state(model, tcfg, mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    if fixed_grads:
        model.loss = _fixed_loss_jax(_fixed_coefs(jax.tree.leaves(params0)))
    step_fn, _ = jax_build_train_step(model, tcfg, mesh)
    key = jax.random.PRNGKey(0)
    losses = []
    with mesh:
        for i in range(MOE_STEPS):
            batch = jax.tree.map(jnp.asarray, jax_synthetic_batch(
                JaxDataConfig(**MOE_DATA), i))
            state, m = step_fn(state, batch, jax.random.fold_in(key, i))
            losses.append(float(m["loss"]))

    def f32(tree):
        return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]
    return {"params0": params0, "losses": losses,
            "params": f32(state.params), "mu": f32(state.opt["mu"]),
            "nu": f32(state.opt["nu"]),
            "residuals": {n: np.asarray(v) for n, v in
                          state.residuals.items()}}


def _moe_port(bf16: bool, params0, fixed_grads: bool = False):
    """The port's steps of the same config from the reference's weights,
    with the reference's QSGD bits: (trainer, losses)."""
    cfg = configs.smoke_config(MOONSHOT)
    if bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16,
                                  param_dtype=torch.bfloat16)
    tcfg = dataclasses.replace(configs.get_train_config(MOONSHOT),
                               schedule=ScheduleConfig(**SCHED))
    model = build_model(cfg)
    if fixed_grads:
        model.loss = _fixed_loss_torch(_fixed_coefs(
            jax.tree.leaves(params0)))
    trainer = Trainer(model, tcfg, DataConfig(**MOE_DATA), dp_total=P_DATA,
                      device="cpu")
    assert trainer.plan.num_sparse_buckets > 0
    trainer.init(params=params_from_jax(params0))
    log = trainer.run(MOE_STEPS, rand_fn_for_step=_reference_rand_fn)
    return trainer, log.losses


def _port_state(trainer) -> dict:
    st = trainer.state

    def f32(tree):
        return [a.float().numpy() for a in tree_flatten(tree)[0]]
    return {"params": f32(st.params), "mu": f32(st.opt["mu"]),
            "nu": f32(st.opt["nu"]),
            "residuals": {n: v.numpy() for n, v in st.residuals.items()}}


def _rel(a, b) -> float:
    """||a - b|| / ||b|| (0 where both are 0)."""
    den = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / den if den else float(
        np.linalg.norm(a))


def _moe_readings(got: dict, ref: dict) -> dict:
    """The largest of each reading over the leaves: the params' update
    error ||p - p_ref|| / ||p_ref - p0||, the moments' and the residuals'
    relative error, and the share of bf16 param entries that are not
    bit-equal."""
    p0 = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref["params0"])]
    upd = [_rel(a - z, b - z) for a, b, z in zip(got["params"],
                                                 ref["params"], p0)]
    return {
        "update": max(upd),
        "moments": max(_rel(a, b) for k in ("mu", "nu")
                       for a, b in zip(got[k], ref[k])),
        "residuals": max(_rel(got["residuals"][n], v)
                         for n, v in ref["residuals"].items()),
        "params_not_equal": max(float(np.mean(a != b)) for a, b in
                                zip(got["params"], ref["params"])),
    }


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_moe_sparcml_steps_match_reference(bf16, monkeypatch):
    """Three SparCML steps of the moonshot smoke config (the configs'
    train_config, the reference's QSGD bits) against the reference; the
    schedule's lr is 0 at step 0, so two of them update the params.

    f32: losses at the QSGD tolerance (rtol 2e-4); the final params, the
    moments and the EF residuals within rtol 2e-4 and 2e-4 of each leaf's
    largest magnitude (a quantization level moved by an L2 scale summed
    in another order reaches them through the update).

    bf16, the published dtype: the two packages round bf16 matmuls and
    elementwise chains at different points, and a gradient entry one ulp
    apart flips TopK picks (k = 4 of 512) that then move their entries by
    a whole Adam step. So the first loss, from the same weights, is held
    at rtol 1e-3 and the later ones at rtol 1e-2, and the state by the
    largest relative error over its leaves: the params' update
    (||p - p_ref|| / ||p_ref - p0||) below 0.85 and the moments' below
    0.92, where the sound run reads 0.73 and 0.84 and a run whose expert
    leaves lose their synced gradient reads 1.0 for both. The fixed-
    gradient test below holds the bf16 sync and update tightly. The state
    keeps its dtypes: bf16 params, f32 EF residuals and moments."""
    ref = _moe_reference(bf16, monkeypatch)
    trainer, losses = _moe_port(bf16, ref["params0"])
    got = _port_state(trainer)
    if not bf16:
        np.testing.assert_allclose(losses, ref["losses"], rtol=2e-4)
        for k in ("params", "mu", "nu"):
            for a, b in zip(got[k], ref[k]):
                np.testing.assert_allclose(
                    a, b, rtol=2e-4, atol=2e-4 * float(np.abs(b).max()))
        for n, b in ref["residuals"].items():
            np.testing.assert_allclose(got["residuals"][n], b, rtol=2e-4,
                                       atol=2e-4 * float(np.abs(b).max()))
        return
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-3)
    np.testing.assert_allclose(losses[1:], ref["losses"][1:], rtol=1e-2)
    readings = _moe_readings(got, ref)
    assert readings["update"] < 0.85, readings
    assert readings["moments"] < 0.92, readings
    st = trainer.state
    for a, path in zip(*tree_flatten(st.params)):
        # the router is f32 in both packages, whatever the model's dtype
        assert a.dtype == (torch.float32 if path[-1] == "router"
                           else torch.bfloat16), path
        assert torch.isfinite(a.float()).all()
    assert all(r.dtype == torch.float32 and torch.isfinite(r).all()
               for r in st.residuals.values())
    assert all(m.dtype == torch.float32 for k in ("mu", "nu")
               for m in tree_flatten(st.opt[k])[0])


def test_moe_bf16_sync_and_update_match_reference(monkeypatch):
    """The bf16 SparCML step's sync and update, with the forward and
    backward taken out of the comparison: both packages' moonshot smoke
    model (bf16) train three steps on a loss whose gradient is exact in
    bf16 and the same in both (:func:`_fixed_loss_jax`). So the bf16
    grads go bit-equal into the fusion, the f32 EF add and TopK, QSGD,
    the clip and the f32 AdamW moments that update the bf16 params, and
    only sums taken in another order (the clip's global norm, the QSGD
    scales) can differ. Held: the EF residuals bit-equal; the moments and
    the f32 router at rtol 1e-5 with a floor of 1e-5 of each leaf's
    largest magnitude; at most 1e-3 of any bf16 leaf's entries differing,
    each by one ulp of its value at most. The sound run reads residuals
    equal, moments within 1.3e-6, no bf16 entry apart; a run whose expert
    leaves lose their synced gradient reads moments 1.0 apart and 99 % of
    the entries of a bf16 leaf apart."""
    ref = _moe_reference(True, monkeypatch, fixed_grads=True)
    trainer, _ = _moe_port(True, ref["params0"], fixed_grads=True)
    got = _port_state(trainer)
    for n, b in ref["residuals"].items():
        np.testing.assert_array_equal(got["residuals"][n], b)
    for k in ("mu", "nu"):
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))
    for a, b, t in zip(got["params"], ref["params"],
                       tree_flatten(trainer.state.params)[0]):
        if t.dtype == torch.float32:        # the router
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))
            continue
        assert t.dtype == torch.bfloat16
        # one bf16 ulp of |b|: 2^16 f32 ulps
        ulp = np.spacing(np.abs(b).astype(np.float32)) * 2.0 ** 16
        assert (np.abs(a - b) <= ulp).all()
        assert float(np.mean(a != b)) <= 1e-3


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
