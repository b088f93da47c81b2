"""The port's prefill and KV-cache decode against the JAX package's.

Inputs are drawn with numpy from a seed; weights are the reference's
(``init_params``), moved over with ``params_from_jax``, and a decode can
start from the reference's own prefill state (``decode_state_from_jax``).

Tolerances. Against the JAX package: the model tolerance of
``tests/test_torch_model.py``, rtol 1e-5 with an absolute floor of 1e-5
of the reference tensor's largest magnitude (the two frameworks sum f32
matmuls in their own orders). Caches hold the same keys and values to
that tolerance, and their padding and ring slots exactly (zeros where
the reference has zeros). Against the port's own full-sequence forward:
1e-4 absolute, the bound ``tests/test_decode_consistency.py`` holds the
reference to. The port's per-slot (vector) decode against its scalar
decode, one row at a time: the model tolerance too, not bit-equality. A
CPU matmul of one row and of four round differently (measured up to
7e-6 absolute on these shapes), as the reference's two forms do (its own
test of this is red, Queue 3 of ROADMAP.md: up to 1.2e-7). Cache rows the
step does not write stay bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import decode_state_from_jax, params_from_jax
from repro_torch.models.model import DecodeState, build_model

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)


def _assert_close(actual, desired):
    desired = np.asarray(desired)
    actual = actual.numpy() if torch.is_tensor(actual) else actual
    np.testing.assert_allclose(actual, desired, rtol=1e-5,
                               atol=1e-5 * float(np.abs(desired).max()))


def _models(**kw):
    kw = {**TINY, **kw}
    jcfg = JaxModelConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32)
    return jax_build_model(jcfg), build_model(cfg)


def _params(jmodel, seed=0):
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _layer0(jparams, params):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])["attn"]
    tp = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0]
                                               for kk, vv in v.items()})
          for k, v in params["blocks"]["attn"].items()}
    return jp, tp


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# attention_prefill
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,cache_len,window,qk_norm", [
    (10, 16, 0, False),      # padded cache
    (12, 8, 0, True),        # the prompt outgrows the cache: its last 8
    (13, 32, 5, False),      # a ring shorter than the prompt
    (4, 32, 6, True),        # a ring the prompt does not fill
], ids=["pad", "keep_last", "ring_wraps", "ring_partial"])
def test_attention_prefill_matches_reference(s, cache_len, window, qk_norm):
    jmodel, model = _models(sliding_window=window, qk_norm=qk_norm)
    jparams, params = _params(jmodel)
    jp, tp = _layer0(jparams, params)
    x = _normal(np.random.default_rng(s), (2, s, 64))
    positions = np.arange(s, dtype=np.int32)
    jout, jcache = JL.attention_prefill(jp, jmodel.cfg, jnp.asarray(x),
                                        jnp.asarray(positions), cache_len)
    out, cache = L.attention_prefill(tp, model.cfg, torch.from_numpy(x),
                                     torch.from_numpy(positions), cache_len)
    _assert_close(out, jout)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy() == 0, want == 0)
        _assert_close(got, want)


@pytest.mark.parametrize("window", [0, 1536], ids=["causal", "window"])
def test_chunked_prefill_matches_reference_and_plain(window):
    """At s = 2048 both packages take the online-softmax chunked form
    (key chunks of 1024): against the reference's, and against the
    port's own non-chunked attention on the same inputs."""
    jmodel, model = _models(num_layers=1, d_model=32, sliding_window=window)
    jparams, params = _params(jmodel)
    jp, tp = _layer0(jparams, params)
    s = 2048
    x = _normal(np.random.default_rng(7), (1, s, 32))
    positions = np.arange(s, dtype=np.int32)
    jout, jcache = JL.attention_prefill(jp, jmodel.cfg, jnp.asarray(x),
                                        jnp.asarray(positions), s)
    xt, pt = torch.from_numpy(x), torch.from_numpy(positions)
    out, cache = L.attention_prefill(tp, model.cfg, xt, pt, s)
    _assert_close(out, jout)
    _assert_close(cache.k, jcache.k)
    _assert_close(L.attention(tp, model.cfg, xt, pt), out.numpy())


# --------------------------------------------------------------------------
# attention_decode
# --------------------------------------------------------------------------

def _decode_inputs(window, b=4):
    w = 6 if window else 12
    rng = np.random.default_rng(0)
    x = _normal(rng, (b, 1, 32))
    k, v = _normal(rng, (b, w, 2, 8)), _normal(rng, (b, w, 2, 8))
    return x, k, v, np.asarray([0, 3, 7, 11], np.int32)


@pytest.mark.parametrize("window", [0, 6], ids=["full", "window"])
def test_attention_decode_matches_reference(window):
    """Both forms against the reference's: the scalar position (each
    position of the vector decoded alone, B = 4) and the per-slot vector."""
    jmodel, model = _models(num_layers=1, d_model=32, vocab_size=64,
                            sliding_window=window)
    jparams, params = _params(jmodel)
    jp, tp = _layer0(jparams, params)
    x, k, v, pos = _decode_inputs(window)
    jx = jnp.asarray(x)
    jkv = JL.KVCache(jnp.asarray(k), jnp.asarray(v))
    for scalar in pos:
        jout, jc = JL.attention_decode(jp, jmodel.cfg, jx, jkv,
                                       jnp.asarray(scalar, jnp.int32))
        cache = L.KVCache(torch.from_numpy(k.copy()),
                          torch.from_numpy(v.copy()))
        out, c = L.attention_decode(tp, model.cfg, torch.from_numpy(x), cache,
                                    torch.tensor(scalar, dtype=torch.int32))
        assert c.k is cache.k                      # written in place
        _assert_close(out, jout)
        _assert_close(c.k, jc.k)
        _assert_close(c.v, jc.v)
    jout, jc = JL.attention_decode(jp, jmodel.cfg, jx, jkv, jnp.asarray(pos))
    cache = L.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    out, c = L.attention_decode(tp, model.cfg, torch.from_numpy(x), cache,
                                torch.from_numpy(pos))
    _assert_close(out, jout)
    _assert_close(c.k, jc.k)
    _assert_close(c.v, jc.v)


@pytest.mark.parametrize("window", [0, 6], ids=["full", "window"])
def test_vector_pos_attention_matches_scalar(window):
    """Each row of the per-slot decode matches that row decoded alone at
    its scalar position, output and cache."""
    jmodel, model = _models(num_layers=1, d_model=32, vocab_size=64,
                            sliding_window=window)
    _, tp = _layer0(*_params(jmodel))
    x, k, v, pos = _decode_inputs(window)
    cache = L.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    o_vec, c_vec = L.attention_decode(tp, model.cfg, torch.from_numpy(x),
                                      cache, torch.from_numpy(pos))
    for i in range(len(pos)):
        one = L.KVCache(torch.from_numpy(k[i:i + 1].copy()),
                        torch.from_numpy(v[i:i + 1].copy()))
        o_s, c_s = L.attention_decode(tp, model.cfg,
                                      torch.from_numpy(x[i:i + 1]), one,
                                      int(pos[i]))
        _assert_close(o_vec[i], o_s[0].numpy())
        _assert_close(c_vec.k[i], c_s.k[0].numpy())
        _assert_close(c_vec.v[i], c_s.v[0].numpy())


def test_vector_pos_past_the_cache_clamps_to_the_last_slot():
    """An inactive slot may sit past the cache end: its write lands on the
    last slot (min(pos, w - 1)) and no other row moves."""
    jmodel, model = _models(num_layers=1, d_model=32, vocab_size=64)
    _, tp = _layer0(*_params(jmodel))
    x, k, v, _ = _decode_inputs(0)
    pos = np.asarray([2, 30, 5, 12], np.int32)
    cache = L.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    L.attention_decode(tp, model.cfg, torch.from_numpy(x), cache,
                       torch.from_numpy(pos))
    for i, p in enumerate(pos):
        slot = min(int(p), 11)
        keep = [j for j in range(12) if j != slot]
        assert torch.equal(cache.k[i, keep], torch.from_numpy(k[i, keep]))
        assert not torch.equal(cache.k[i, slot], torch.from_numpy(k[i, slot]))


# --------------------------------------------------------------------------
# prefill + decode_step
# --------------------------------------------------------------------------

CASES = {
    "plain": dict(),
    "qk_norm": dict(qk_norm=True),
    "window": dict(sliding_window=6),
    "gelu_tied": dict(act_fn="gelu", tie_embeddings=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_match_reference_and_forward(case):
    """Prefill 8 tokens into a cache of 16, decode 4 more: each step's
    logits against the reference's and against the port's own forward
    over the whole sequence; the final caches against the reference's."""
    jmodel, model = _models(**CASES[case])
    jparams, params = _params(jmodel, seed=1)
    toks = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
    full = model.forward(params, {"tokens": torch.from_numpy(toks)})
    jlg, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8])},
                              cache_len=16)
    lg, st = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :8])},
                           cache_len=16)
    assert st.pos.dtype == torch.int32 and int(st.pos) == 8
    _assert_close(lg, jlg)
    errs = [float((lg - full[:, 7]).abs().max())]
    for t in range(8, 12):
        tok = toks[:, t:t + 1]
        jlg, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        lg, st = model.decode_step(params, st, torch.from_numpy(tok))
        _assert_close(lg, jlg)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs
    assert int(st.pos) == int(jst.pos) == 12
    assert tuple(st.kv.k.shape) == jst.kv.k.shape
    _assert_close(st.kv.k, jst.kv.k)
    _assert_close(st.kv.v, jst.kv.v)


MOE = dict(family="moe", num_experts=4, experts_per_token=2, moe_d_ff=64,
           capacity_factor=4.0)


@pytest.mark.parametrize("shared", [0, 96], ids=["routed", "shared"])
def test_moe_prefill_decode_match_reference_and_forward(shared):
    """The MoE family (the reference's decode-consistency model: 4 experts
    top-2, capacity factor 4 so neither the forward nor a step drops an
    assignment): prefill 8 tokens, decode 4, each step's logits against
    the reference's and the port's own forward; the final caches against
    the reference's."""
    jmodel, model = _models(**MOE, moe_shared_ff=shared)
    jparams, params = _params(jmodel, seed=4)
    toks = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(np.int32)
    full = model.forward(params, {"tokens": torch.from_numpy(toks)})
    jlg, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8])},
                              cache_len=16)
    lg, st = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :8])},
                           cache_len=16)
    _assert_close(lg, jlg)
    errs = [float((lg - full[:, 7]).abs().max())]
    for t in range(8, 12):
        tok = toks[:, t:t + 1]
        jlg, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        lg, st = model.decode_step(params, st, torch.from_numpy(tok))
        _assert_close(lg, jlg)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs
    assert int(st.pos) == int(jst.pos) == 12
    _assert_close(st.kv.k, jst.kv.k)
    _assert_close(st.kv.v, jst.kv.v)


def test_moe_decode_from_the_reference_prefill_state():
    """decode_state_from_jax takes a MoE state (the dense family's pos and
    kv fields), and the port decodes from it step for step with the
    reference."""
    jmodel, model = _models(**MOE)
    jparams, params = _params(jmodel, seed=5)
    toks = np.random.default_rng(5).integers(0, 256, (2, 9)).astype(np.int32)
    _, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :6])},
                            cache_len=16)
    st = decode_state_from_jax(jax.tree.map(np.asarray, jst))
    np.testing.assert_array_equal(st.kv.v.numpy(), np.asarray(jst.kv.v))
    for t in range(6, 9):
        tok = toks[:, t:t + 1]
        jlg, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        lg, st = model.decode_step(params, st, torch.from_numpy(tok))
        _assert_close(lg, jlg)


def test_decode_from_the_reference_prefill_state():
    """decode_state_from_jax: the port decodes from the reference's own
    prefill state, step for step with the reference."""
    jmodel, model = _models(sliding_window=5)
    jparams, params = _params(jmodel, seed=2)
    toks = np.random.default_rng(2).integers(0, 256, (3, 11)).astype(np.int32)
    _, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :7])},
                            cache_len=16)
    st = decode_state_from_jax(jax.tree.map(np.asarray, jst))
    assert isinstance(st, DecodeState) and st.pos.dtype == torch.int32
    np.testing.assert_array_equal(st.kv.k.numpy(), np.asarray(jst.kv.k))
    for t in range(7, 11):
        tok = toks[:, t:t + 1]
        jlg, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        lg, st = model.decode_step(params, st, torch.from_numpy(tok))
        _assert_close(lg, jlg)


OTHER = {
    "ssm": dict(family="ssm", ssm_state=16, ssm_head_dim=16, ssm_chunk=4),
    "hybrid": dict(family="hybrid", ssm_state=16, ssm_head_dim=16,
                   ssm_chunk=4, attn_every=2, sliding_window=5),
    "vlm": dict(family="vlm", cross_attn_every=2, num_image_tokens=8,
                vision_dim=48, num_layers=4),
}


def _pairs(a, b):
    """The tensors of a state field (a KV pair or one tensor) side by
    side with the reference's."""
    return zip(a, b) if isinstance(a, tuple) else [(a, b)]


@pytest.mark.parametrize("fam", list(OTHER))
def test_decode_state_conversion_of_other_families(fam):
    """decode_state_from_jax converts the ssm, hybrid and vlm states field
    for field: the empty state (the port's own init_decode_state has the
    same shapes and zeros) and a prefill's, bit for bit."""
    jmodel, model = _models(**OTHER[fam])
    jst = jmodel.init_decode_state(3, 16, prefix_len=2)
    st = model.init_decode_state(3, 16, prefix_len=2, device="cpu")
    conv = decode_state_from_jax(jax.tree.map(np.asarray, jst))
    for got in (st, conv):
        assert int(got.pos) == 2 and got.pos.dtype == torch.int32
        for name in ("kv", "cross_kv", "conv", "ssm"):
            a, b = getattr(got, name), getattr(jst, name)
            assert (a is None) == (b is None), name
            if a is not None:
                for x, y in _pairs(a, b):
                    assert tuple(x.shape) == y.shape and not x.any(), name
    assert st.ssm is None or st.ssm.dtype == torch.float32
    jparams, _ = _params(jmodel, seed=3)
    rng = np.random.default_rng(3)
    batch = {"tokens": jnp.asarray(rng.integers(0, 256, (2, 8)).astype(
        np.int32))}
    if fam == "vlm":
        batch["image_embeds"] = jnp.asarray(rng.standard_normal(
            (2, 8, 48)).astype(np.float32))
    _, jst = jmodel.prefill(jparams, batch, cache_len=16)
    conv = decode_state_from_jax(jax.tree.map(np.asarray, jst))
    for name in ("kv", "cross_kv", "conv", "ssm"):
        if getattr(jst, name) is not None:
            for x, y in _pairs(getattr(conv, name), getattr(jst, name)):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("window", [0, 6], ids=["full", "window"])
def test_init_decode_state_matches_reference(window):
    jmodel, model = _models(sliding_window=window)
    jst = jmodel.init_decode_state(3, 16, prefix_len=2)
    st = model.init_decode_state(3, 16, prefix_len=2, device="cpu")
    assert tuple(st.kv.k.shape) == jst.kv.k.shape
    assert int(st.pos) == int(jst.pos) == 2
    assert not st.kv.k.any() and not st.kv.v.any()


def test_per_slot_model_decode_matches_scalar_rows():
    """decode_step with a (B,) position vector over two slots at
    different depths matches each slot decoded alone from its own B = 1
    state, logits and caches."""
    jmodel, model = _models()
    _, params = _params(jmodel)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (1, n)).astype(np.int32) for n in (3, 9)]
    singles = [model.prefill(params, {"tokens": torch.from_numpy(p)}, 16)
               for p in prompts]
    batch = model.init_decode_state(2, 16, device="cpu")
    batch = batch._replace(pos=torch.zeros(2, dtype=torch.int32))
    for i, (_, sub) in enumerate(singles):
        batch.kv.k[:, i] = sub.kv.k[:, 0]
        batch.kv.v[:, i] = sub.kv.v[:, 0]
        batch.pos[i] = sub.pos
    toks = torch.from_numpy(rng.integers(0, 256, (2, 1)).astype(np.int32))
    lg, st = model.decode_step(params, batch, toks)
    assert st.pos.tolist() == [4, 10]
    for i, (_, sub) in enumerate(singles):
        lg1, st1 = model.decode_step(params, sub, toks[i:i + 1])
        _assert_close(lg[i], lg1[0].numpy())
        _assert_close(st.kv.k[:, i], st1.kv.k[:, 0].numpy())


def test_ssm_prefill_needs_whole_chunks_and_unknown_families_raise():
    """The SSD scan needs a prompt of whole chunks: the port's prefill
    refuses another length, as the reference's asserts; nothing pads. A
    family neither package knows raises at every entry point."""
    jmodel, model = _models(**OTHER["ssm"])
    jparams, params = _params(jmodel)
    toks = np.arange(6, dtype=np.int32)[None]
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        model.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
    with pytest.raises(AssertionError, match="% chunk"):
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_len=16)
    bad = build_model(ModelConfig(**{**TINY, "family": "rnn"},
                                  dtype=torch.float32,
                                  param_dtype=torch.float32))
    with pytest.raises(ValueError, match="unknown family"):
        bad.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        bad.forward({}, {"tokens": torch.zeros((1, 2), dtype=torch.int32)})
    with pytest.raises(ValueError, match="unknown family"):
        bad.init_decode_state(2, 8, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        bad.prefill({}, {"tokens": torch.zeros((1, 2), dtype=torch.int32)},
                    8)
