"""The port's dense LM against the JAX package's on the same weights.

Weights come from the reference's ``init_params`` and move over with
``params_from_jax``. Tolerance for logits, loss and every gradient:
rtol=1e-5, and an absolute floor of 1e-5 of the tensor's largest
magnitude. Both frameworks sum the f32 matmuls in their own order, so
the error scales with the tensor, not with each entry: measured, it stays
below 1.7e-6 of the largest magnitude in every tensor, while entries near
zero differ by more than atol=1e-6 alone would allow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, init_params
from repro_torch.utils.tree import tree_flatten, tree_unflatten

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)


def _assert_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, rtol=1e-5,
                               atol=1e-5 * float(np.abs(desired).max()))


def _models(**kw):
    kw = {**TINY, **kw}
    jcfg = JaxModelConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32)
    return jax_build_model(jcfg), build_model(cfg)


def test_synthetic_batch_is_the_reference_stream():
    for step in (0, 7):
        a = synthetic_batch(DataConfig(4, 16, 256), step)
        b = jax_synthetic_batch(JaxDataConfig(4, 16, 256), step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_init_params_shapes_and_scales_match_reference():
    jmodel, model = _models()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    jl, jdef = jax.tree.flatten(jparams)
    leaves, _ = tree_flatten(params)
    assert len(jl) == len(leaves)
    for a, b in zip(leaves, jl):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        b = np.asarray(b)
        if b.std() == 0:                     # norm scales: exactly ones
            assert torch.equal(a, torch.from_numpy(b.copy()))
        else:                                # same init scale within 10%
            assert abs(float(a.std()) / float(b.std()) - 1) < 0.1
    meta = init_params(model.cfg, device="meta")
    assert [tuple(m.shape) for m in tree_flatten(meta)[0]] == \
        [tuple(a.shape) for a in leaves]


@pytest.mark.parametrize("variant", [
    {},
    {"qk_norm": True, "sliding_window": 8},
    {"act_fn": "gelu", "num_kv_heads": 4, "tie_embeddings": True},
], ids=["llama", "qknorm_window", "gelu_mha_tied"])
def test_logits_loss_grads_match_reference(variant):
    jmodel, model = _models(**variant)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = synthetic_batch(DataConfig(3, 24, 256), 5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    jlogits = jmodel.forward(jparams, jbatch)
    logits = model(params, tbatch)
    _assert_close(logits.detach().numpy(), jlogits)

    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jbatch))(
        jparams)
    leaves, paths = tree_flatten(params)
    live = [p.clone().requires_grad_(True) for p in leaves]
    loss = model.loss(tree_unflatten(paths, live), tbatch)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _assert_close(g.numpy(), jg)
