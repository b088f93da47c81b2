"""Every model family of the port against the JAX package's, on the
reference's tiny models (its ``tests/test_decode_consistency.py`` CASES,
plus the encoder).

Weights are the reference's (``init_params``), moved over with
``params_from_jax``; inputs are drawn with numpy from a seed. The vlm's
gates (``xattn.gate`` and ``mlp_gate``) are set non-zero before the
conversion: at their init of 0 the cross-attention adds nothing and gets
no gradient, which would hide it from the comparison (one test holds
that property itself).

Tolerances. Against the JAX package: the model tolerance of
``tests/test_torch_model.py``, rtol 1e-5 with an absolute floor of 1e-5
of the reference tensor's largest magnitude, for logits, loss, every
gradient and every decode step. Decode against the port's own
full-sequence forward: 1e-4 absolute, the bound the reference's test
holds it to. Remat on against off: bit-equal, loss and grads, through
the training step's ``rank_grads`` (vmap over ranks of grad_and_value).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as JL
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import decode_state_from_jax, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.train.train_step import rank_grads
from repro_torch.utils.tree import tree_flatten, tree_unflatten

BASE = dict(name="t", num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=256, max_seq_len=64, ssm_chunk=4)
CASES = {
    "dense": dict(family="dense", qk_norm=True),
    "moe": dict(family="moe", num_experts=4, experts_per_token=2,
                moe_d_ff=64, capacity_factor=4.0),
    "ssm": dict(family="ssm", ssm_state=16, ssm_head_dim=16),
    "hybrid": dict(family="hybrid", ssm_state=16, ssm_head_dim=16,
                   attn_every=2),
    "vlm": dict(family="vlm", cross_attn_every=2, num_image_tokens=8,
                vision_dim=48),
    "encoder": dict(family="encoder", frontend_dim=32, act_fn="gelu",
                    causal=False),
}
DECODERS = [f for f in CASES if f != "encoder"]
B, S, PROMPT = 2, 12, 8
# one smoke config of each family
SMOKE = {"dense": "qwen3-4b", "moe": "moonshot-v1-16b-a3b",
         "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
         "vlm": "llama-3.2-vision-11b", "encoder": "hubert-xlarge"}


def _assert_close(actual, desired):
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy() if torch.is_tensor(actual) \
        else actual
    np.testing.assert_allclose(actual, desired, rtol=1e-5,
                               atol=1e-5 * float(np.abs(desired).max()))


def _models(fam, **kw):
    kw = {**BASE, **CASES[fam], **kw}
    jcfg = JaxModelConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32)
    return jax_build_model(jcfg), build_model(cfg)


def _open_gates(jparams):
    """Non-zero vlm gates (tanh(0.5) on the attention, tanh(-0.7) on the
    MLP), so the cross layers count."""
    cross = jparams["blocks"]["cross"]
    cross["xattn"]["gate"] = jnp.full_like(cross["xattn"]["gate"], 0.5)
    cross["mlp_gate"] = jnp.full_like(cross["mlp_gate"], -0.7)
    return jparams


def _params(jmodel, fam, seed=1):
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if fam == "vlm":
        jparams = _open_gates(jparams)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _batch(cfg, rng, b=B, s=S) -> dict:
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encoder":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _grads(model, params, batch):
    leaves, paths = tree_flatten(params)
    live = [p.clone().requires_grad_(True) for p in leaves]
    loss = model.loss(tree_unflatten(paths, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    # an unused leaf (the encoder's token embedding) has a zero gradient,
    # as jax.grad gives it
    return loss, [torch.zeros_like(p) if g is None else g
                  for g, p in zip(grads, live)]


@pytest.mark.parametrize("fam", list(CASES))
def test_init_shapes_match_reference(fam):
    """The params tree (keys, leaf order, shapes, dtypes) is the
    reference's, on the CPU and on the meta device; the stacked
    superblocks of hybrid and vlm included."""
    jmodel, model = _models(fam)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jl, _ = jax.tree.flatten_with_path(want)
    for device in ("cpu", "meta"):
        params = model.init(torch.Generator().manual_seed(0), device=device)
        leaves, paths = tree_flatten(params)
        assert [tuple(str(getattr(k, "key", k)) for k in p)
                for p, _ in jl] == [tuple(p) for p in paths]
        assert [tuple(a.shape) for a in leaves] == [a.shape for _, a in jl]
        assert all(str(a.dtype).split(".")[-1] == str(b.dtype)
                   for a, (_, b) in zip(leaves, jl))


@pytest.mark.parametrize("fam", list(CASES))
def test_logits_loss_grads_match_reference(fam):
    jmodel, model = _models(fam)
    jparams, params = _params(jmodel, fam)
    jb, tb = _both(_batch(model.cfg, np.random.default_rng(0)))
    _assert_close(model(params, tb), jmodel.forward(jparams, jb))
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jb))(
        jparams)
    loss, grads = _grads(model, params, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _assert_close(g, jg)


@pytest.mark.parametrize("fam", DECODERS)
def test_prefill_decode_match_reference(fam):
    """Prefill at 8 tokens, then 4 decode steps: the port from its own
    prefill state and from the reference's (``decode_state_from_jax``)
    against the reference's steps; the port's steps against its own
    teacher-forced forward."""
    jmodel, model = _models(fam)
    jparams, params = _params(jmodel, fam, seed=2)
    batch = _batch(model.cfg, np.random.default_rng(1))
    jb, tb = _both(batch)
    full = model(params, tb)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    pre["tokens"] = pre["tokens"][:, :PROMPT]
    jpre, tpre = _both(pre)
    jlg, jst = jmodel.prefill(jparams, jpre, cache_len=16)
    lg, st = model.prefill(params, tpre, 16)
    conv = decode_state_from_jax(jax.tree.map(np.asarray, jst))
    _assert_close(lg, jlg)
    assert np.abs(lg.numpy() - full[:, PROMPT - 1].detach().numpy()).max() \
        < 1e-4
    for t in range(PROMPT, S):
        tok = batch["tokens"][:, t:t + 1]
        jlg, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        lg, st = model.decode_step(params, st, torch.from_numpy(tok))
        clg, conv = model.decode_step(params, conv, torch.from_numpy(tok))
        _assert_close(lg, jlg)
        _assert_close(clg, jlg)
        assert np.abs(lg.numpy() - full[:, t].detach().numpy()).max() < 1e-4
    assert int(st.pos) == int(jst.pos) == S
    for name in ("conv", "ssm"):
        if getattr(jst, name) is not None:
            _assert_close(getattr(st, name), getattr(jst, name))


def test_cross_attention_matches_reference():
    """layers.cross_attention (the image K/V of ``cross_kv`` attended by
    ``cross_attend``) against the reference's, with an open gate."""
    jmodel, model = _models("vlm")
    jparams, params = _params(jmodel, "vlm")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["cross"]["xattn"])
    p = {k: v[0] if torch.is_tensor(v) else {"scale": v["scale"][0]}
         for k, v in params["blocks"]["cross"]["xattn"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    feats = rng.standard_normal((2, 8, 64)).astype(np.float32)
    want = JL.cross_attention(jp, jmodel.cfg, jnp.asarray(x),
                              jnp.asarray(feats))
    got = L.cross_attention(p, model.cfg, torch.from_numpy(x),
                            torch.from_numpy(feats))
    _assert_close(got, want)
    assert float(np.abs(np.asarray(want)).max()) > 0


def test_vlm_cross_layers_at_their_init_gates():
    """At the init gates of 0 the cross-attention adds nothing (the
    logits equal those of the same model with the image embeddings
    zeroed) and its projections and the vision projection get a zero
    gradient, as in the reference; the gates themselves get one."""
    jmodel, model = _models("vlm")
    jparams = jmodel.init(jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = _batch(model.cfg, np.random.default_rng(3))
    jb, tb = _both(batch)
    blank = dict(tb, image_embeds=torch.zeros_like(tb["image_embeds"]))
    assert torch.equal(model(params, tb), model(params, blank))
    _, grads = _grads(model, params, tb)
    jgrads = jax.grad(lambda p: jmodel.loss(p, jb))(jparams)
    by_path = dict(zip(tree_flatten(params)[1], grads))
    for path in [("blocks", "cross", "xattn", w)
                 for w in ("wq", "wk", "wv", "wo")] + [
            ("blocks", "cross", "mlp", "wi"), ("vision_proj",)]:
        assert not by_path[path].any(), path
        node = jgrads
        for k in path:
            node = node[k]
        assert not np.asarray(node).any(), path
    assert by_path[("blocks", "cross", "xattn", "gate")].abs().min() > 0
    _assert_close(by_path[("blocks", "cross", "xattn", "gate")],
                  jgrads["blocks"]["cross"]["xattn"]["gate"])


@pytest.mark.parametrize("fam", list(SMOKE))
def test_remat_on_and_off_bit_equal(fam):
    """cfg.remat (the default) recomputes each block in the backward; on
    the family's smoke config, through the training step's vmap over
    ranks of grad_and_value, the loss and every rank's grads are
    bit-equal to remat off."""
    cfg = configs.smoke_config(SMOKE[fam])
    assert cfg.remat
    on, off = build_model(cfg), build_model(dataclasses.replace(
        cfg, remat=False))
    params = on.init(torch.Generator().manual_seed(4), device="cpu")
    if fam == "vlm":
        params["blocks"]["cross"]["xattn"]["gate"].fill_(0.5)
        params["blocks"]["cross"]["mlp_gate"].fill_(-0.7)
    batch = {k: torch.from_numpy(v) for k, v in _batch(
        cfg, np.random.default_rng(4), b=4, s=16).items()}
    loss_on, g_on = rank_grads(on, params, batch, 2, 2)
    loss_off, g_off = rank_grads(off, params, batch, 2, 2)
    assert torch.isfinite(loss_on) and torch.equal(loss_on, loss_off)
    assert len(g_on) == len(g_off)
    for a, b, path in zip(g_on, g_off, tree_flatten(params)[1]):
        assert torch.equal(a, b), path


def test_encoder_has_no_decode():
    """hubert is encoder-only: prefill and decode refuse, as the
    reference's decode step does; the reference's decode state for it
    holds no cache and converts as such."""
    jmodel, model = _models("encoder")
    _, params = _params(jmodel, "encoder")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder-only archs have no decode"):
        model.prefill(params, {"tokens": tokens}, 8)
    st = model.init_decode_state(1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only archs have no decode"):
        model.decode_step(params, st, tokens[:, :1])
    jparams = jmodel.init(jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="encoder-only archs have no "
                                             "decode"):
        jmodel.decode_step(jparams, jmodel.init_decode_state(1, 8),
                           jnp.zeros((1, 1), jnp.int32))
    conv = decode_state_from_jax(jax.tree.map(
        np.asarray, jmodel.init_decode_state(1, 8)))
    assert conv.kv is conv.cross_kv is conv.conv is conv.ssm is None
    assert st._replace(pos=None) == conv._replace(pos=None)


def test_smoke_configs_of_the_families_are_the_reference_families():
    for fam, arch in SMOKE.items():
        assert configs.smoke_config(arch).family == \
            jax_configs.smoke_config(arch).family == fam
