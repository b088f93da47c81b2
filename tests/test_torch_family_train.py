"""Three SparCML training steps of each new family's smoke config (ssm,
hybrid, vlm, encoder) against the JAX package's train step.

Both start from the same weights (the reference's, through
``params_from_jax``) and see the same batches, the stub frontends'
inputs included (``DataConfig.kind``); the port gets the reference's own
QSGD rounding bits through ``rand_fn``. The reference is forced onto its
stacked-replica (auto-SPMD) path, the form the port takes, as in
``tests/test_torch_train.py``.

Tolerances (f32, with QSGD-4): losses at rtol 2e-4, where an L2 scale
summed in another order can move one entry by a whole quantization
level; the final params, moments and EF residuals within rtol 2e-4 and
2e-4 of each leaf's largest magnitude (that level reaches them through
the update), as the MoE family's f32 test holds them.
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
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.model import build_model as jax_build_model
from repro.optim.schedule import ScheduleConfig as JaxScheduleConfig
from repro.train.train_step import build_train_step as jax_build_train_step
from repro.train.train_step import init_state as jax_init_state
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_flatten

P_DATA = 4
# three steps: the schedule's lr is 0 at step 0, so steps 1 and 2 are the
# ones that update the params
STEPS = 3
SCHED = dict(kind="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=10)


def _reference_rand_fn(step):
    """The reference's QSGD bits of ``step`` (same key as the run)."""
    skey = jax.random.fold_in(jax.random.PRNGKey(0), step)

    def rand_fn(bucket_idx, n):
        bits = _qsgd_rand_all(skey, bucket_idx, 1, P_DATA, n // P_DATA)
        return torch.from_numpy(np.array(bits).reshape(-1))

    return rand_fn


def _port_state(trainer) -> dict:
    st = trainer.state

    def f32(tree):
        return [a.float().numpy() for a in tree_flatten(tree)[0]]
    return {"params": f32(st.params), "mu": f32(st.opt["mu"]),
            "nu": f32(st.opt["nu"]),
            "residuals": {n: v.numpy() for n, v in st.residuals.items()}}


FAMILY_ARCHS = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
                "vlm": "llama-3.2-vision-11b", "encoder": "hubert-xlarge"}
DATA_KIND = {"vlm": "vlm", "encoder": "audio"}


def _family_data(cfg, cls, microbatches):
    """One 16-token row a rank a microbatch, with the family's stub
    frontend inputs (frames, image embeddings) from the same generator."""
    return cls(global_batch=P_DATA * microbatches, seq_len=16,
               vocab_size=cfg.vocab_size,
               kind=DATA_KIND.get(cfg.family, "lm"),
               frontend_dim=cfg.frontend_dim,
               num_image_tokens=cfg.num_image_tokens,
               vision_dim=cfg.vision_dim)


@pytest.mark.parametrize("fam", list(FAMILY_ARCHS))
def test_family_sparcml_steps_match_reference(fam, monkeypatch):
    """Three SparCML steps of each new family's smoke config (f32) under
    its own train_config (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1, its
    microbatches; remat on, the default) against the reference's train
    step on the stacked ranks, from the reference's weights with its QSGD
    bits: losses at rtol 2e-4; the final params, the moments and the EF
    residuals within rtol 2e-4 and 2e-4 of each leaf's largest magnitude,
    as the MoE family's f32 test above. The schedule's lr is 0 at step 0,
    so two steps update the params."""
    arch = FAMILY_ARCHS[fam]
    monkeypatch.setattr(compat, "partial_manual_collectives_broken",
                        lambda mesh, axes: True)
    mesh = compat.make_mesh((P_DATA, 1), ("data", "model"))
    jtcfg = dataclasses.replace(jax_configs.get_train_config(arch, mesh),
                                schedule=JaxScheduleConfig(**SCHED))
    jmodel = jax_build_model(jax_configs.smoke_config(arch))
    state, _ = jax_init_state(jmodel, jtcfg, mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    step_fn, _ = jax_build_train_step(jmodel, jtcfg, mesh)
    jdata = _family_data(jmodel.cfg, JaxDataConfig, jtcfg.microbatches)
    key = jax.random.PRNGKey(0)
    ref_losses = []
    with mesh:
        for i in range(STEPS):
            batch = jax.tree.map(jnp.asarray, jax_synthetic_batch(jdata, i))
            state, m = step_fn(state, batch, jax.random.fold_in(key, i))
            ref_losses.append(float(m["loss"]))

    cfg = configs.smoke_config(arch)
    tcfg = dataclasses.replace(configs.get_train_config(arch),
                               schedule=ScheduleConfig(**SCHED))
    trainer = Trainer(build_model(cfg), tcfg,
                      _family_data(cfg, DataConfig, tcfg.microbatches),
                      dp_total=P_DATA, device="cpu")
    assert trainer.plan.num_sparse_buckets > 0 and cfg.remat
    trainer.init(params=params_from_jax(params0))
    losses = trainer.run(STEPS, rand_fn_for_step=_reference_rand_fn
                         ).losses
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    got = _port_state(trainer)

    def f32(tree):
        return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]
    want = {"params": f32(state.params), "mu": f32(state.opt["mu"]),
            "nu": f32(state.opt["nu"])}
    for k in ("params", "mu", "nu"):
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, rtol=2e-4,
                                       atol=2e-4 * float(np.abs(b).max()))
    assert set(got["residuals"]) == set(state.residuals)
    for n, b in state.residuals.items():
        b = np.asarray(b)
        np.testing.assert_allclose(got["residuals"][n], b, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(b).max()))
