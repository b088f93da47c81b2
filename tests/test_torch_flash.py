"""The chunked training attention (``layers.flash_attention``) against the
JAX package's ``flash_attention`` and ``attention``, at S = 2048 (two
1024-key chunks), on the CPU.

Inputs are seeded numpy arrays, f32. Tolerance: rtol 1e-5 with an
absolute floor of 1e-5 of the tensor's largest magnitude (as
``test_torch_model.py``): both sides sum the chunks in the same order,
but each framework sums a matmul's products in its own order. The bf16
case holds the rounding points: at most 1 % of entries may differ from
the reference (an f32 sum rounded the other way), by at most 2e-3 of the
tensor's largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.train.train_step import rank_grads
from repro_torch.utils.tree import tree_flatten, tree_unflatten

S, NH, NKV, HD = 2048, 4, 2, 16
VARIANTS = {"causal": (True, 0), "noncausal": (False, 0),
            "window1024": (True, 1024)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The models here are small: two threads do, and the other test
    workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=1e-5,
                               atol=1e-5 * float(np.abs(desired).max()))


def _qkv(seed, lead=(1,)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(lead + (S, NH, HD)).astype(np.float32)
            for _ in range(4)]                           # q, k, v, dout


def _torch_vjp(q, k, v, dout, causal, window):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    pos = torch.arange(S, dtype=torch.int32)
    out = L.flash_attention(q, k, v, pos, causal, window, 1024)
    return out, torch.autograd.grad(out, (q, k, v), torch.from_numpy(dout))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_attention_matches_reference(variant):
    """Forward, dq, dk and dv against jax.vjp of the reference's
    flash_attention (causal, non-causal, a sliding window of 1024)."""
    causal, window = VARIANTS[variant]
    q, k, v, dout = _qkv(0)
    pos = jnp.arange(S, dtype=jnp.int32)
    jout, vjp = jax.vjp(lambda a, b, c: JL.flash_attention(
        a, b, c, pos, causal, window, 1024), q, k, v)
    out, grads = _torch_vjp(q, k, v, dout, causal, window)
    _assert_close(out.detach(), jout)
    for g, jg in zip(grads, vjp(jnp.asarray(dout))):
        _assert_close(g, jg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_attention_bf16_matches_reference(variant):
    """In bf16, forward, dq, dk and dv against jax.vjp of the reference's
    flash_attention: every product an f32 sum, rounded to bf16 where the
    reference rounds. A backward that rounds dp or each chunk's dq to
    bf16 before its f32 use differs on about 60 % of entries, by up to
    1.5e-2 of the largest magnitude; this one on at most 0.4 %, by at
    most 1.1e-3."""
    causal, window = VARIANTS[variant]
    q, k, v, dout = _qkv(0)
    bf = jnp.bfloat16
    pos = jnp.arange(S, dtype=jnp.int32)
    jout, vjp = jax.vjp(lambda a, b, c: JL.flash_attention(
        a, b, c, pos, causal, window, 1024),
        *(jnp.asarray(a).astype(bf) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(dout).astype(bf))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (q, k, v))
    out = L.flash_attention(tq, tk, tv, torch.arange(S, dtype=torch.int32),
                            causal, window, 1024)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(dout).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    for got, ref in zip((out.detach(),) + grads, (jout,) + tuple(jgrads)):
        got = got.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.mean(got != ref) <= 1e-2
        assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()


def _attn_params(seed):
    rng = np.random.default_rng(seed)
    d = 64
    w = lambda *sh: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(
        np.float32)
    return {"wq": w(d, NH * HD), "wk": w(d, NKV * HD), "wv": w(d, NKV * HD),
            "wo": w(NH * HD, d),
            "q_norm": {"scale": (1 + 0.1 * rng.standard_normal(HD)).astype(
                np.float32)},
            "k_norm": {"scale": (1 + 0.1 * rng.standard_normal(HD)).astype(
                np.float32)}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_gqa_matches_reference(variant):
    """``attention`` at S = 2048 with GQA 4/2 and qk-norm (the head repeat
    outside the Function, so k's and v's gradients sum over the repeated
    heads through autograd): output and the gradients of x and every
    projection against the reference's ``attention``."""
    causal, window = VARIANTS[variant]
    kw = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=NH, num_kv_heads=NKV, head_dim=HD, d_ff=128,
              vocab_size=256, qk_norm=True, sliding_window=window or None,
              max_seq_len=S)
    jcfg = JaxModelConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32)
    p = _attn_params(1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, S, 64)).astype(np.float32)
    ct = rng.standard_normal((1, S, 64)).astype(np.float32)
    jpos = jnp.arange(S, dtype=jnp.int32)
    jout, vjp = jax.vjp(lambda pp, xx: JL.attention(
        pp, jcfg, xx, jpos, causal=causal), jax.tree.map(jnp.asarray, p),
        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))

    leaves, paths = tree_flatten(jax.tree.map(torch.from_numpy, p))
    live = [t.clone().requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = L.attention(tree_unflatten(paths, live), cfg, xt,
                      torch.arange(S, dtype=torch.int32), causal=causal)
    grads = torch.autograd.grad(out, live + [xt], torch.from_numpy(ct))
    _assert_close(out.detach(), jout)
    _assert_close(grads[-1], jgx)
    jleaves = [jgp[a] if b is None else jgp[a][b]
               for a, b in (("k_norm", "scale"), ("q_norm", "scale"),
                            ("wk", None), ("wo", None), ("wq", None),
                            ("wv", None))]
    assert [pth for pth in paths] == [("k_norm", "scale"),
                                      ("q_norm", "scale"), ("wk",), ("wo",),
                                      ("wq",), ("wv",)]
    for g, jg in zip(grads[:-1], jleaves):
        _assert_close(g, jg)


def test_chunked_switch_and_saved_tensors(monkeypatch):
    """``attention`` takes the Function exactly where the reference
    switches (S >= 2048, S % 1024 == 0); the backward saves no tensor of
    S x T entries (the plain path saves several); (B, S) positions never
    reach the chunked path."""
    calls = []
    apply = L._FlashAttention.apply
    monkeypatch.setattr(L._FlashAttention, "apply",
                        lambda *a: calls.append(a[0].shape[1]) or apply(*a))
    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                      num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                      vocab_size=64, dtype=torch.float32,
                      param_dtype=torch.float32, max_seq_len=4096)
    p = {k: torch.randn(shape, generator=torch.Generator().manual_seed(0))
         for k, shape in (("wq", (32, 32)), ("wk", (32, 16)),
                          ("wv", (32, 16)), ("wo", (32, 32)))}
    largest = {}
    for s in (1024, 2048, 2560, 3072):
        x = torch.randn((1, s, 32), requires_grad=True)
        sizes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: sizes.append(t.numel()) or t, lambda t: t):
            out = L.attention(p, cfg, x, torch.arange(s, dtype=torch.int32))
        out.sum().backward()
        largest[s] = max(sizes)
    assert calls == [2048, 3072]
    assert largest[1024] >= 1024 * 1024 and largest[2560] >= 2560 * 2560
    assert largest[2048] < 2048 * 2048 and largest[3072] < 3072 * 3072
    with pytest.raises(ValueError, match="one \\(S,\\) row of positions"):
        L.attention(p, cfg, torch.randn((2, 2048, 32)),
                    torch.arange(2048).repeat(2, 1))


def test_vmap_of_grad_over_ranks_equals_single_calls():
    """Under ``torch.func.vmap(torch.func.grad(...))`` over 2 ranks (the
    training step's rank grads), each rank's dq, dk, dv equal a single
    call's bit for bit."""
    q, k, v, dout = (torch.from_numpy(a) for a in _qkv(3, lead=(2, 1)))
    pos = torch.arange(S, dtype=torch.int32)

    def f(q, k, v, dout):
        return (L.flash_attention(q, k, v, pos, True, 0, 1024) * dout).sum()

    grad = torch.func.grad(f, argnums=(0, 1, 2))
    batched = torch.func.vmap(grad)(q, k, v, dout)
    for r in range(2):
        for a, b in zip(batched, grad(q[r], k[r], v[r], dout[r])):
            assert torch.equal(a[r], b)


def _long_smoke():
    """qwen3-4b's smoke config with max_seq_len 2048, both packages."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen3-4b"),
                               max_seq_len=S)
    cfg = dataclasses.replace(configs.smoke_config("qwen3-4b"),
                              max_seq_len=S)
    return jcfg, cfg


@pytest.fixture
def deterministic():
    """The embedding's backward is a scatter-add whose CPU form sums
    repeated tokens in no fixed order at 2048 tokens (two remat-off runs
    differ by 7e-9); its deterministic form sums them in one order."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_remat_on_and_off_bit_equal_through_the_chunked_path(deterministic):
    """The Function inside ``_Remat``'s recompute (its backward calls
    torch.func.vjp on the block) through rank_grads' vmap over 2 ranks:
    the loss and every rank's grads bit-equal to remat off."""
    _, cfg = _long_smoke()
    cfg = dataclasses.replace(cfg, num_layers=2)
    assert cfg.remat
    on, off = build_model(cfg), build_model(dataclasses.replace(
        cfg, remat=False))
    params = on.init(torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S),
                                           dtype=np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    loss_on, g_on = rank_grads(on, params, batch, 2, 1)
    loss_off, g_off = rank_grads(off, params, batch, 2, 1)
    assert torch.isfinite(loss_on) and torch.equal(loss_on, loss_off)
    for a, b, path in zip(g_on, g_off, tree_flatten(params)[1]):
        assert torch.equal(a, b), path


def test_qwen3_smoke_at_2048_matches_reference():
    """qwen3-4b's smoke config (4 layers, GQA 4/2, qk-norm, remat on) at
    one row of 2048 tokens, through the chunked path in both packages:
    loss and every gradient against the reference's jax.value_and_grad,
    on the same weights (``params_from_jax``)."""
    jcfg, cfg = _long_smoke()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(6))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (1, S), dtype=np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "labels": torch.from_numpy(tokens)}
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jbatch))(
        jparams)
    leaves, paths = tree_flatten(params)
    live = [t.clone().requires_grad_(True) for t in leaves]
    loss = model.loss(tree_unflatten(paths, live), tbatch)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _assert_close(g, jg)
