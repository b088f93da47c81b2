"""fsdp (ZeRO-3) and the per-rank dense step of the port against the JAX
package's ``fsdp=True`` dense step, on the CPU.

* The shard layout (``models.specs.fsdp_layout``) against the
  reference's ``param_specs(..., ("data",))`` leaf by leaf at p = 2 and
  4: the sharded dim, and each rank's range against the reference's
  ``devices_indices_map`` on a (p, 1) mesh; padding where p does not
  divide the dim.
* Three steps of the port's fsdp step over ``StackedCollectives(2)`` and
  ``(4)``, and of the per-rank dense step (no fsdp) over
  ``StackedCollectives(2)``, against three steps of the reference's
  ``fsdp=True`` dense step on a 2 x 1 mesh: the same weights (the
  reference's, through ``params_from_jax``) and the same
  ``synthetic_batch`` rows. Losses within rtol 1e-5; the gathered params
  within rtol 1e-5 and a floor of 1e-5 of each tensor's largest
  magnitude (the model parity tolerance).
* llama3-405b's and dbrx-132b's own ``train_config`` (dense, fsdp, bf16
  moments, 16 and 8 microbatches) at their smoke configs over 2 stacked
  ranks (dbrx over 1 too), the same way (dbrx's experts drop what the
  reference's global step drops: see its test).

Two threads, as the other CPU-heavy files pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro import configs as jc
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.models.specs import param_specs as jax_param_specs
from repro.optim.optimizers import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.train.state import TrainConfig as JaxTrainConfig
from repro.train.train_step import build_train_step as jax_build_train_step
from repro.train.train_step import init_state as jax_init_state
from repro_torch import configs as tc
from repro_torch.comm.collectives import StackedCollectives
from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, init_params
from repro_torch.models.specs import fsdp_layout
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_flatten

STEPS = 3
RTOL = 1e-5
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=10)
LAYOUT_ARCHS = ("dbrx-132b", "llama3-405b", "llama-3.2-vision-11b",
                "hubert-xlarge", "zamba2-2.7b")


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=RTOL):
    """Within rtol of each entry and a floor of rtol of the tensor's
    largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = rtol * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def test_fsdp_with_sparcml_raises_the_references_error():
    with pytest.raises(ValueError) as want:
        JaxTrainConfig(sync=JaxSyncConfig(mode="sparcml"), fsdp=True)
    with pytest.raises(ValueError) as got:
        TrainConfig(sync=SyncConfig(mode="sparcml"), fsdp=True)
    assert str(got.value) == str(want.value)
    assert TrainConfig(sync=SyncConfig(mode="dense"), fsdp=True).fsdp


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_shard_layout_matches_reference_specs(arch, p):
    """Each leaf's sharded dim is the one the reference's spec gives the
    data axes, and where p divides it, rank r's range is the reference's
    slice on a (p, 1) mesh; leaves without a data axis stay whole."""
    jcfg = jc.smoke_config(arch)
    pshapes = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    jspecs = jax_param_specs(pshapes, jcfg, ("data",))
    mesh = compat.make_mesh((p, 1), ("data", "model"),
                            devices=jax.devices()[:p])
    cfg = tc.smoke_config(arch)
    lays, paths = tree_flatten(fsdp_layout(init_params(cfg, device="meta"),
                                           cfg, p))
    jleaves = jax.tree_util.tree_flatten_with_path(pshapes)[0]
    jspec_leaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
        x, P))
    assert len(jleaves) == len(lays)
    n_sharded = 0
    for (jpath, sd), spec, lay, path in zip(jleaves, jspec_leaves, lays,
                                            paths):
        assert tuple(k.key for k in jpath) == path
        # P normalises a one-axis tuple to its name
        dims = [i for i, ax in enumerate(tuple(spec))
                if ax in ("data", ("data",))]
        if not dims:
            assert lay.dim is None, path
            continue
        n_sharded += 1
        assert lay.dim == dims[0] and lay.size == sd.shape[lay.dim], path
        assert lay.shard == -(-lay.size // p) and lay.p == p
        if lay.size % p:
            continue
        index = NamedSharding(mesh, spec).devices_indices_map(sd.shape)
        for r in range(p):
            sl = index[mesh.devices[r, 0]][lay.dim]
            assert lay.rank_range(r) == (sl.start, sl.stop), (path, r)
    assert n_sharded > 0


def test_shard_cut_pads_and_round_trips():
    """p = 3 does not divide 64: the dim is zero-padded to 66, each rank
    holds 22, and the shards joined and unpadded give the leaf back."""
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    layout = ts.fsdp_layout_of(build_model(cfg), 3)
    shards = ts.shard_params(params, layout, range(3))
    whole = ts.gather_params(shards, layout, StackedCollectives(3, "cpu"))
    for (x, path), y, lay, s in zip(zip(*tree_flatten(params)),
                                    tree_flatten(whole)[0],
                                    tree_flatten(layout)[0],
                                    tree_flatten(shards)[0]):
        assert torch.equal(x, y), path
        if lay.dim is None:
            assert s is x
            continue
        assert s.shape[0] == 3 and s.shape[lay.dim + 1] == 22
        assert not s[2].narrow(lay.dim, 20, 2).any()       # the padding


def _reference(jcfg, jtcfg, data, mesh, steps=STEPS):
    """The reference's dense (fsdp) step: (initial params as numpy, the
    losses, the final params as numpy)."""
    model = jax_build_model(jcfg)
    step_fn, _ = jax_build_train_step(model, jtcfg, mesh)
    state, _ = jax_init_state(model, jtcfg, mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    key = jax.random.PRNGKey(0)
    losses = []
    with mesh:
        for i in range(steps):
            batch = jax.tree.map(jnp.asarray, jax_synthetic_batch(data, i))
            state, m = step_fn(state, batch, jax.random.fold_in(key, i))
            losses.append(float(m["loss"]))
    return params0, losses, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def data_mesh():
    """The reference's mesh here: 2 data ranks x model 1 (on the 4 x 2
    mesh this build's reference gives the MoE smoke model other
    gradients than on any data-only mesh)."""
    return compat.make_mesh((2, 1), ("data", "model"),
                            devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def tiny_reference(data_mesh):
    jtcfg = JaxTrainConfig(sync=JaxSyncConfig(mode="dense"),
                           optimizer=JaxOptimizerConfig(),
                           schedule=JaxScheduleConfig(**SCHED),
                           microbatches=2, fsdp=True)
    return _reference(JaxModelConfig(**TINY, dtype=jnp.float32,
                                     param_dtype=jnp.float32),
                      jtcfg, JaxDataConfig(**DATA), data_mesh)


def _port_run(cfg, tcfg, data, p, params0, steps=STEPS):
    """The port's steps over StackedCollectives(p): (losses, the params
    gathered whole, the trainer)."""
    trainer = Trainer(build_model(cfg), tcfg, data, dp_total=p,
                      device="cpu", lowering="manual")
    trainer.init(params=params_from_jax(params0))
    losses = trainer.run(steps).losses
    params = trainer.state.params
    if tcfg.fsdp:
        params = ts.gather_params(params, trainer.fsdp_layout,
                                  StackedCollectives(p, "cpu"))
    return losses, params, trainer


def _check(run, ref):
    losses, params, _ = run
    _, ref_losses, ref_params = ref
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    got, paths = tree_flatten(params)
    want = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    assert [tuple(k.key for k in jp) for jp, _ in want] == paths
    for g, (_, w), path in zip(got, want, paths):
        assert tuple(g.shape) == w.shape, path
        _close(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("fsdp,p", [(True, 2), (True, 4), (False, 2)])
def test_per_rank_dense_steps_match_reference_fsdp(tiny_reference, fsdp, p):
    """fsdp over the stacked ranks (each holding its shards), and the
    per-rank dense step with whole params, against the reference's
    fsdp=True step: losses and params after three steps."""
    tcfg = TrainConfig(sync=SyncConfig(mode="dense"),
                       optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       fsdp=fsdp)
    run = _port_run(ModelConfig(**TINY, dtype=torch.float32,
                                param_dtype=torch.float32),
                    tcfg, DataConfig(**DATA), p, tiny_reference[0])
    state = run[2].state
    if fsdp:
        lays = tree_flatten(run[2].fsdp_layout)[0]
        for x, m, lay in zip(tree_flatten(state.params)[0],
                             tree_flatten(state.opt["mu"])[0], lays):
            assert m.shape == x.shape
            if lay.dim is not None:
                assert x.shape[0] == p and x.shape[lay.dim + 1] == lay.shard
    _check(run, tiny_reference)


@pytest.mark.parametrize("arch,p", [("llama3-405b", 2), ("dbrx-132b", 1),
                                    ("dbrx-132b", 2)])
def test_arch_fsdp_train_config_matches_reference(arch, p, data_mesh):
    """The arch's own train_config (dense, fsdp, bf16 moments, its
    microbatches) at its smoke config over StackedCollectives(p),
    against the reference's config on the data mesh, two steps. dbrx's
    experts drop the assignments past the capacity of the reference's
    whole global microbatch: each rank routes its rows, and at p = 2 the
    ranks share the capacity (``moe.shared_capacity``)."""
    jcfg, cfg = jc.smoke_config(arch), tc.smoke_config(arch)
    jtcfg = jc.get_train_config(arch, data_mesh)
    tcfg = tc.get_train_config(arch)
    assert tcfg.fsdp and jtcfg.fsdp
    rows = p * tcfg.microbatches      # one row a rank a microbatch
    data = dict(global_batch=rows, seq_len=16, vocab_size=cfg.vocab_size)
    ref = _reference(jcfg, jtcfg, JaxDataConfig(**data), data_mesh,
                     steps=2)
    run = _port_run(cfg, tcfg, DataConfig(**data), p, ref[0], steps=2)
    assert run[2].state.opt["mu"]["embed"].dtype == torch.bfloat16
    _check(run, ref)


def test_fsdp_checkpoints_cross_sizes_and_packages(tmp_path, data_mesh):
    """An fsdp checkpoint is written whole ("full", the reference's fsdp
    state): 2 stacked ranks' checkpoint resumes over 4 ranks with the
    same whole params and moments, the reference restores it, and the
    reference's own fsdp checkpoint resumes in the port."""
    from repro.train import checkpoint as jax_ckpt
    from repro_torch.train import checkpoint as ckpt

    tcfg = TrainConfig(sync=SyncConfig(mode="dense"),
                       optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       fsdp=True)
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))

    def trainer(p, d):
        return Trainer(model, tcfg, DataConfig(**DATA), dp_total=p,
                       device="cpu", ckpt_dir=str(d))

    def whole(tr):
        coll = StackedCollectives(tr.dp_total, "cpu")
        st = tr.state
        return [x for tree in (st.params, st.opt["mu"], st.opt["nu"])
                for x in tree_flatten(ts.gather_params(
                    tree, tr.fsdp_layout, coll))[0]]

    two = trainer(2, tmp_path / "port")
    two.init()
    two.run(2)
    assert ckpt.load_meta(str(tmp_path / "port"))["opt_layout"] == "full"
    four = trainer(4, tmp_path / "port")
    assert four.init_or_resume() == 2
    for a, b in zip(whole(four), whole(two)):
        assert torch.equal(a, b)

    jtcfg = JaxTrainConfig(sync=JaxSyncConfig(mode="dense"),
                           optimizer=JaxOptimizerConfig(),
                           schedule=JaxScheduleConfig(**SCHED),
                           microbatches=2, fsdp=True)
    jstate, _ = jax_init_state(jax_build_model(JaxModelConfig(
        **TINY, dtype=jnp.float32, param_dtype=jnp.float32)), jtcfg,
        data_mesh)
    back = jax_ckpt.restore(str(tmp_path / "port"), jstate, dp_total=2,
                            verify=True)
    jleaves = [np.asarray(x) for tree in (back.params, back.opt["mu"],
                                          back.opt["nu"])
               for x in jax.tree.leaves(tree)]
    assert int(back.step) == 2
    for a, b in zip(whole(two), jleaves):
        np.testing.assert_array_equal(a.numpy(), b)

    jax_ckpt.save(str(tmp_path / "jax"), jstate, dp_total=2,
                  opt_layout="full")
    mine = trainer(2, tmp_path / "jax")
    assert mine.init_or_resume() == 0
    for a, b in zip(tree_flatten(ts.gather_params(
            mine.state.params, mine.fsdp_layout,
            StackedCollectives(2, "cpu")))[0],
            jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
