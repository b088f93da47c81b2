"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the JAX
package's ``repro.models.mamba2``.

Inputs are drawn with numpy from a seed; the block's weights are the
reference's (``mamba_init``), moved over with ``params_from_jax``.

Tolerances. f32 against the reference: the model tolerance of
``tests/test_torch_model.py``, rtol 1e-5 with an absolute floor of 1e-5
of the reference tensor's largest magnitude (the two frameworks sum f32
products in their own orders). The decode chained over a sequence
against the port's own full-sequence forward: the same tolerance (the
recurrence and the chunked scan sum the same terms in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.models import mamba2 as tm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax

TINY = dict(name="t", family="ssm", num_layers=2, d_model=32, num_heads=1,
            num_kv_heads=1, d_ff=0, vocab_size=64, ssm_state=16,
            ssm_head_dim=16, ssm_chunk=4, conv_width=4, max_seq_len=64)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_close(actual, desired):
    desired = np.asarray(desired, np.float32)
    actual = actual.detach().float().numpy() if torch.is_tensor(actual) \
        else actual
    np.testing.assert_allclose(actual, desired, rtol=1e-5,
                               atol=1e-5 * float(np.abs(desired).max()))


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (JaxModelConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32),
            ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32))


def _block(seed=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    jp = jm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    # non-trivial dt_bias, D and conv bias: their init (0, 1, 0) would hide
    # a wrong broadcast
    rng = np.random.default_rng(seed)
    for name in ("dt_bias", "D", "conv_b"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape).astype(
            np.float32) * 0.5)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _ssd_inputs(rng, bs=2, s=12, h=3, p=4, n=5):
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(
        np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    b = rng.standard_normal((bs, s, n)).astype(np.float32)
    c = rng.standard_normal((bs, s, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a_log, b, c, d


@pytest.mark.parametrize("s,chunk", [(12, 4), (16, 4), (24, 8)],
                         ids=["nc3", "nc4", "nc3_q8"])
def test_ssd_chunked_matches_reference(s, chunk):
    """y and the final state at nc >= 3 chunks, so the inter-chunk
    recurrence carries a state across at least two chunk boundaries."""
    args = _ssd_inputs(np.random.default_rng(s), s=s)
    jy, jst = jm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    y, st = tm.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert tuple(st.shape) == jst.shape == (2, 3, 4, 5)
    _assert_close(y, jy)
    _assert_close(st, jst)


def test_ssd_chunked_refuses_a_ragged_sequence():
    """``s % chunk == 0`` is the scan's precondition (the reference
    asserts it); nothing pads."""
    args = _ssd_inputs(np.random.default_rng(0), s=10)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tm.ssd_chunked(*map(torch.from_numpy, args), chunk=4)


def test_segsum_masks_with_zero_gradient():
    """-inf above the diagonal, the reference's values below it, and a
    backward through exp() that is exactly 0 there, never NaN."""
    x = np.random.default_rng(1).standard_normal((2, 3, 6)).astype(
        np.float32)
    want = np.asarray(jm._segsum(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm._segsum(xt)
    upper = np.triu(np.ones((6, 6), bool), k=1)
    assert np.isneginf(got.detach().numpy()[..., upper]).all()
    _assert_close(got.detach().numpy()[..., ~upper], want[..., ~upper])
    (g,) = torch.autograd.grad(torch.exp(got).sum(), xt)
    assert torch.isfinite(g).all()
    jg = jax.grad(lambda a: jnp.exp(jm._segsum(a)).sum())(jnp.asarray(x))
    _assert_close(g, jg)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(2)
    seq = rng.standard_normal((2, 9, 7)).astype(np.float32)
    w = rng.standard_normal((4, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    want = jm._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                           jnp.asarray(bias))
    got = tm._causal_conv(*map(torch.from_numpy, (seq, w, bias)))
    _assert_close(got, want)
    # causal: the first output sees only the first input
    np.testing.assert_allclose(got[:, 0].numpy(), seq[:, 0] * w[-1] + bias,
                               rtol=1e-6)


def test_mamba_init_shapes_match_reference():
    jcfg, cfg = _cfgs()
    shapes = jax.eval_shape(lambda k: jm.mamba_init(k, jcfg),
                            jax.random.PRNGKey(0))
    p = tm.mamba_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: tuple(v["scale"].shape if k == "norm" else v.shape)
            for k, v in p.items()} == {
        k: (v["scale"].shape if k == "norm" else v.shape)
        for k, v in shapes.items()}
    ref = jm.mamba_init(jax.random.PRNGKey(0), jcfg)
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        _assert_close(p[name], ref[name])
    stacked = tm.mamba_init(None, cfg, "meta", lead=(3, 2))
    assert stacked["in_proj"].shape == (3, 2) + tuple(p["in_proj"].shape)
    assert stacked["A_log"].shape == (3, 2, cfg.ssm_heads)


@pytest.mark.parametrize("s", [8, 12])
def test_mamba_apply_matches_reference_with_grads(s):
    jcfg, cfg, jp, p = _block()
    x = np.random.default_rng(3).standard_normal((2, s, 32)).astype(
        np.float32)
    jy, jst = jm.mamba_apply(jp, jcfg, jnp.asarray(x))
    y, st = tm.mamba_apply(p, cfg, torch.from_numpy(x))
    _assert_close(y, jy)
    _assert_close(st, jst)
    # gradients of a scalar of the output, every weight and the input
    jgrads = jax.grad(lambda pp, xx: jnp.sum(jm.mamba_apply(pp, jcfg, xx)[0]
                                             * jnp.cos(xx)),
                      argnums=(0, 1))(jp, jnp.asarray(x))
    live = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v) else
                {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
            for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = (tm.mamba_apply(live, cfg, xt)[0] * torch.cos(xt)).sum()
    names = sorted(live)
    leaves = [live[k]["scale"] if k == "norm" else live[k] for k in names]
    grads = torch.autograd.grad(out, leaves + [xt])
    for k, g in zip(names, grads):
        jg = jgrads[0][k]["scale"] if k == "norm" else jgrads[0][k]
        _assert_close(g, jg)
    _assert_close(grads[-1], jgrads[1])


def test_mamba_decode_chain_matches_apply_and_reference():
    """mamba_decode over a sequence, one token at a time from zero
    states, gives mamba_apply's outputs and final state; each step equals
    the reference's mamba_decode from the same states; the states are
    written in place."""
    jcfg, cfg, jp, p = _block(seed=4)
    s = 12
    x = np.random.default_rng(5).standard_normal((2, s, 32)).astype(
        np.float32)
    full, final = tm.mamba_apply(p, cfg, torch.from_numpy(x))
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    conv = torch.zeros((2, cfg.conv_width - 1, conv_dim))
    ssm = torch.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    jconv, jssm = jnp.zeros(conv.shape), jnp.zeros(ssm.shape)
    for t in range(s):
        xt = torch.from_numpy(x[:, t:t + 1])
        y, c2, s2 = tm.mamba_decode(p, cfg, xt, conv, ssm)
        assert c2 is conv and s2 is ssm
        jy, jconv, jssm = jm.mamba_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                          jconv, jssm)
        _assert_close(y, jy)
        _assert_close(conv, jconv)
        _assert_close(ssm, jssm)
        _assert_close(y[:, 0], full[:, t].numpy())
    _assert_close(ssm, final.numpy())
