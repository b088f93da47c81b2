"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX package's: the same on-disk format, so each restores the other's.

Both packages train the same tiny model two steps from the same weights
(the reference with ZeRO-1 off and the same dp, its optimizer state then
param-shaped like the port's). A checkpoint written by one and restored
by the other must list the same leaf paths in the same order and give
back every value bit for bit. Then the port's integrity checks (a flipped
byte raises, the newest valid checkpoint is found), atomic writes and
retention, and its trainer's resume in both loops.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.optim.optimizers import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.train import checkpoint as jax_ckpt
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
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer

P_DATA = 4
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=10)
SYNC = dict(k_per_bucket=4, bucket_size=128, algorithm="dsar_split_allgather",
            min_sparse_size=1024)
MODES = ["sparcml", "dense"]


def _port_tcfg(mode, zero1=False):
    return TrainConfig(sync=SyncConfig(mode=mode, **SYNC),
                       optimizer=OptimizerConfig(),
                       schedule=ScheduleConfig(**SCHED), microbatches=2,
                       zero1=zero1)


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
def states(model):
    """mode -> (JAX state, port state), each two steps from the same
    weights: values differ between the packages, layouts do not."""
    out = {}
    for mode in MODES:
        jmodel = jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                                param_dtype=jnp.float32))
        jtcfg = JaxTrainConfig(
            sync=JaxSyncConfig(mode=mode, **SYNC, impl="ref"),
            optimizer=JaxOptimizerConfig(), schedule=JaxScheduleConfig(**SCHED),
            microbatches=2, zero1=False)
        mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
        step_fn, _ = jax_build_train_step(jmodel, jtcfg, mesh)
        jstate, _ = jax_init_state(jmodel, jtcfg, mesh)
        params0 = jax.tree.map(np.asarray, jstate.params)
        with mesh:
            for i in range(2):
                batch = jax.tree.map(jnp.asarray, jax_synthetic_batch(
                    JaxDataConfig(**DATA), i))
                jstate, _ = step_fn(jstate, batch, jax.random.PRNGKey(i))
        tcfg = _port_tcfg(mode)
        fn, plan = ts.build_train_step(model, tcfg, P_DATA, "cpu")
        state = ts.init_state(model, tcfg, plan, "cpu",
                              params=params_from_jax(params0))
        for i in range(2):
            state, _ = fn(state, synthetic_batch(DataConfig(**DATA), i))
        out[mode] = jstate, state
    return out


def _jax_leaves(state):
    return jax.tree_util.tree_leaves(state)


def _port_leaves(state):
    _, leaves = ckpt._flatten_with_paths(state)
    return [leaf for leaf in leaves if leaf is not None]


def _assert_bit_equal(port_leaves, jax_leaves):
    assert len(port_leaves) == len(jax_leaves)
    for p, j in zip(port_leaves, jax_leaves):
        j = np.asarray(j)
        p = np.asarray(p, dtype=np.int32) if isinstance(p, int) else p.numpy()
        assert p.dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("mode", MODES)
def test_jax_checkpoint_restores_in_the_port(states, tmp_path, mode):
    jstate, like = states[mode]
    jax_ckpt.save(str(tmp_path), jstate, dp_total=P_DATA, opt_layout="full")
    meta = ckpt.load_meta(str(tmp_path))
    assert ckpt._flatten_with_paths(like)[0] == meta["paths"]
    restored = ckpt.restore(str(tmp_path), like, dp_total=P_DATA,
                            verify=True)
    assert restored.step == 2 and restored.inflight is None
    assert (restored.residuals is None) == (mode == "dense")
    _assert_bit_equal(_port_leaves(restored), _jax_leaves(jstate))


@pytest.mark.parametrize("mode", MODES)
def test_port_checkpoint_restores_in_jax(states, tmp_path, mode):
    like, state = states[mode]
    ckpt.save(str(tmp_path), state, dp_total=P_DATA, opt_layout="full")
    meta = jax_ckpt.load_meta(str(tmp_path))
    assert jax_ckpt._flatten_with_paths(like)[0] == meta["paths"]
    assert meta["opt_layout"] == "full" and meta["dp_total"] == P_DATA
    assert jax_ckpt.verify_checkpoint(str(tmp_path), 2)
    restored = jax_ckpt.restore(str(tmp_path), like, dp_total=P_DATA,
                                verify=True)
    _assert_bit_equal(_port_leaves(state), _jax_leaves(restored))


def _flip_a_byte(directory, step):
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_flipped_byte_raises_and_falls_back(states, tmp_path):
    _, state = states["sparcml"]
    d = str(tmp_path)
    for step in (2, 3):
        ckpt.save(d, state._replace(step=step), dp_total=P_DATA)
    _flip_a_byte(d, 3)
    assert not ckpt.verify_checkpoint(d, 3)
    assert ckpt.verify_checkpoint(d, 2)
    assert ckpt.latest_step(d) == 3 and ckpt.latest_valid_step(d) == 2
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, state, dp_total=P_DATA, verify=True)
    assert ckpt.restore(d, state, dp_total=P_DATA, step=2,
                        verify=True).step == 2
    _flip_a_byte(d, 2)
    assert ckpt.latest_valid_step(d) is None


def test_save_is_atomic_and_keeps_the_last(states, tmp_path):
    _, state = states["sparcml"]
    d = str(tmp_path)
    for step in range(5):
        ckpt.save(d, state._replace(step=step), dp_total=P_DATA, keep_last=2,
                  extra_meta={"note": step})
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert ckpt.load_meta(d)["note"] == 4
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(d, state._replace(residuals=None), dp_total=P_DATA)
    with pytest.raises(ValueError, match="dp_total"):
        bad = {k: v[:2] for k, v in state.residuals.items()}
        ckpt.restore(d, state._replace(residuals=bad), dp_total=2)


def _trainer(model, ckpt_dir, ckpt_every=4):
    return Trainer(model, _port_tcfg("sparcml"), DataConfig(**DATA),
                   dp_total=P_DATA, device="cpu", ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every)


def test_trainer_run_pipelined_checkpoints_interoperate(model, tmp_path):
    """run_pipelined writes synchronous-shaped checkpoints (in-flight
    buffers stripped at the drain barrier), so a fresh Trainer resumes
    from them, bit for bit, in either loop."""
    d = str(tmp_path)
    tr = _trainer(model, d)
    log = tr.run_pipelined(8, staleness=1, superstep=2, depth=2)
    assert len(log.losses) == 8 and tr.state.step == 8
    assert tr.state.inflight is not None
    assert ckpt.latest_step(d) == 8
    assert ckpt.load_meta(d, 8)["paths"][-1] == ".inflight"

    tr2 = _trainer(model, d)
    assert tr2.init_or_resume() == 8
    assert tr2.state.inflight is None and tr2.log.restarts == 1
    for a, b in zip(_port_leaves(tr2.state),
                    _port_leaves(tr.state._replace(inflight=None))):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    tr2.run_pipelined(10, staleness=1, superstep=2)
    assert tr2.state.step == 10
    tr2.run(12)
    assert tr2.state.step == 12 and tr2.state.inflight is None
    assert ckpt.latest_step(d) == 12


def test_jax_trainer_checkpoint_resumes_in_the_port(model, tmp_path):
    """A checkpoint the JAX package's Trainer wrote (ZeRO-1 off) is where
    the port's Trainer starts, and it trains on from it."""
    from repro.train.trainer import Trainer as JaxTrainer

    d = str(tmp_path)
    jtcfg = JaxTrainConfig(
        sync=JaxSyncConfig(mode="sparcml", **SYNC, impl="ref"),
        optimizer=JaxOptimizerConfig(), schedule=JaxScheduleConfig(**SCHED),
        microbatches=2, zero1=False)
    jtr = JaxTrainer(
        jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                       param_dtype=jnp.float32)),
        jtcfg, compat.make_mesh((P_DATA, 1), ("data", "model")),
        JaxDataConfig(**DATA), ckpt_dir=d, ckpt_every=100)
    jtr.run(3)
    tr = _trainer(model, d)
    assert tr.init_or_resume() == 3
    _assert_bit_equal(_port_leaves(tr.state), _jax_leaves(jtr.state))
    log = tr.run_pipelined(5, superstep=2)
    assert tr.state.step == 5 and np.isfinite(log.losses).all()


def test_run_restores_after_a_failure(model, tmp_path):
    tr = _trainer(model, str(tmp_path), ckpt_every=2)
    log = tr.run(6, fail_at=3)
    assert log.restarts == 1 and tr.state.step == 6
    assert len(log.losses) == 7          # step 2 ran twice after the restore


def test_resume_refuses_a_zero_layout(model, tmp_path):
    """A full-layout run (zero1=False) does not resume a ZeRO checkpoint:
    only zero1_leaf <-> zero_scattered convert (the reference's rule)."""
    tr = _trainer(model, str(tmp_path))
    tr.init()
    ckpt.save(str(tmp_path), tr.state, dp_total=P_DATA,
              opt_layout="zero1_leaf")
    with pytest.raises(ValueError, match="not resumable"):
        _trainer(model, str(tmp_path)).init_or_resume()


def test_jax_default_zero1_checkpoint_resumes_in_the_port(model, tmp_path):
    """The reference's default config trains under ZeRO-1 (as its example
    does), so its checkpoints are "zero1_leaf": the port's default config
    (zero1 too) resumes one bit for bit, trains on from it, and its own
    checkpoint restores in the reference."""
    from repro.train.trainer import Trainer as JaxTrainer

    d = str(tmp_path)
    jtcfg = JaxTrainConfig(
        sync=JaxSyncConfig(mode="sparcml", **SYNC, impl="ref"),
        optimizer=JaxOptimizerConfig(), schedule=JaxScheduleConfig(**SCHED),
        microbatches=2)
    assert jtcfg.zero1 and TrainConfig().zero1
    jtr = JaxTrainer(
        jax_build_model(JaxModelConfig(**TINY, dtype=jnp.float32,
                                       param_dtype=jnp.float32)),
        jtcfg, compat.make_mesh((P_DATA, 1), ("data", "model")),
        JaxDataConfig(**DATA), ckpt_dir=d, ckpt_every=100)
    jtr.run(3)
    assert jax_ckpt.load_meta(d)["opt_layout"] == "zero1_leaf"
    tr = Trainer(model, _port_tcfg("sparcml", zero1=True), DataConfig(**DATA),
                 dp_total=P_DATA, device="cpu", ckpt_dir=d, ckpt_every=100)
    assert tr.init_or_resume() == 3
    _assert_bit_equal(_port_leaves(tr.state), _jax_leaves(jtr.state))
    log = tr.run_pipelined(5, superstep=2)
    assert tr.state.step == 5 and np.isfinite(log.losses).all()
    assert ckpt.load_meta(d)["opt_layout"] == "zero1_leaf"
    back = jax_ckpt.restore(d, jtr.state, dp_total=P_DATA, verify=True)
    assert int(back.step) == 5
    _assert_bit_equal(_port_leaves(tr.state._replace(inflight=None)),
                      _jax_leaves(back))
