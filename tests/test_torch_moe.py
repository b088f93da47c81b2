"""The port's MoE layer (``models/moe.py``) and MoE models against the JAX
package's ``repro.models.moe`` and ``repro.models.model``.

Inputs are drawn with numpy from a seed; weights are the reference's
(``moe_init`` / ``init_params``), moved over with ``params_from_jax``.

Tolerances. Routing (the top-k expert ids) and the dispatch's slot maps
are integers and compared bit for bit. Values follow
``tests/test_torch_model.py``'s rule: rtol 1e-5 with an absolute floor of
1e-5 of the reference tensor's largest magnitude (the frameworks sum f32
matmuls in their own orders), for outputs and for gradients alike (the
reference's model tests hold gradients to the same). The router's top-k
weights come from a softmax and a renormalizing sum whose orders may
differ, so they are held to the same tolerance, not bit for bit. Within the port, the serve dispatch's row-stream
exchange is bit-equal to its dense sum, ``rank_grads`` is bit-equal to a
loop over the ranks, and reruns are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.comm.executor import exchange_activation_spmd as jax_exchange
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.comm.executor import exchange_activation_spmd
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.train.train_step import _accumulated_grads, rank_grads
from repro_torch.utils.tree import tree_flatten, tree_unflatten

MOE = dict(name="t", family="moe", num_layers=2, d_model=64, num_heads=4,
           num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64,
           num_experts=8, experts_per_token=2, moe_d_ff=32)
SMOKES = ["moonshot-v1-16b-a3b", "dbrx-132b"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_close(actual, desired):
    desired = np.asarray(desired)
    actual = actual.detach().numpy() if torch.is_tensor(actual) else actual
    np.testing.assert_allclose(actual, desired, rtol=1e-5,
                               atol=1e-5 * float(np.abs(desired).max()))


def _cfgs(**kw):
    kw = {**MOE, **kw}
    return (JaxModelConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32),
            ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32))


def _layer(jcfg, seed=0):
    """One layer's reference MoE params and the port's copy."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _x(t, d, seed=0, common=0.0):
    """(t, d) normal tokens; ``common`` adds one shared random direction
    to every token, so they crowd the same experts (past capacity)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)) + common * rng.standard_normal(d)
    return x.astype(np.float32)


def _reference_slots(jp, jcfg, x, active=None):
    """The reference's routing and slot maps, computed by the steps of
    ``repro.models.moe.moe_apply`` (``moe_apply_serve`` when ``active`` is
    given: capacity T, inactive slots routed to the sentinel expert)."""
    t = x.shape[0]
    e, k = jcfg.num_experts, jcfg.experts_per_token
    c = t if active is not None else jmoe.capacity(jcfg, t)
    gates = jax.nn.softmax((x @ jp["router"]).astype(jnp.float32))
    w, eidx = jax.lax.top_k(gates, k)
    w = w / (w.sum(-1, keepdims=True) + 1e-9)
    flat_e = eidx.reshape(-1).astype(jnp.int32)
    if active is not None:
        flat_e = jnp.where(jnp.repeat(active, k), flat_e, e)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(e, dtype=jnp.int32))
    pos = jnp.arange(t * k, dtype=jnp.int32) - \
        seg_start[jnp.minimum(sorted_e, e - 1)]
    keep = (pos < c) & (sorted_e < e)
    slot = jnp.where(keep, sorted_e * c + pos, e * c)
    slot_token = jnp.full((e * c,), t, jnp.int32).at[slot].set(
        (order // k).astype(jnp.int32), mode="drop")
    return np.asarray(eidx), np.asarray(w), np.asarray(slot_token), c


def _port_slots(p, cfg, x, active=None):
    t = x.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    c = t if active is not None else moe.capacity(cfg, t)
    w, eidx = moe._route(p, x, k)
    flat_e = eidx.reshape(-1)
    if active is not None:
        flat_e = torch.where(torch.repeat_interleave(active, k), flat_e,
                             torch.full_like(flat_e, e))
    return eidx, w, moe._dispatch(flat_e, w, t, k, e, c), c


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 4.0],
                         ids=["drops", "dropfree"])
@pytest.mark.parametrize("shared", [0, 48], ids=["routed", "shared"])
def test_moe_apply_matches_reference(capacity_factor, shared):
    """Routing ids and the slot -> token map bit-equal, the output within
    the model tolerance; at capacity factor 1.25 assignments are dropped
    (checked), at 4.0 none is."""
    jcfg, cfg = _cfgs(capacity_factor=capacity_factor, moe_shared_ff=shared)
    jp, p = _layer(jcfg, seed=1)
    x = _x(48, 64, seed=2, common=3.0)
    jeidx, jw, jslot_token, c = _reference_slots(jp, jcfg, jnp.asarray(x))
    eidx, w, dsp, c2 = _port_slots(p, cfg, torch.from_numpy(x))
    assert c == c2 == moe.capacity(cfg, 48)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    _assert_close(w, jw)
    np.testing.assert_array_equal(dsp.slot_token.numpy(), jslot_token)
    dropped = int((dsp.token_slots == cfg.num_experts * c).sum())
    assert (dropped > 0) == (capacity_factor == 1.25)
    y = moe.moe_apply(p, cfg, torch.from_numpy(x))
    _assert_close(y, jmoe.moe_apply(jp, jcfg, jnp.asarray(x)))
    # the combine's fixed order: a rerun is bit-equal
    assert torch.equal(y, moe.moe_apply(p, cfg, torch.from_numpy(x)))


def test_capacity_matches_reference():
    for cf, t in [(1.25, 1), (1.25, 48), (1.25, 512), (4.0, 8), (4.0, 37)]:
        jcfg, cfg = _cfgs(capacity_factor=cf)
        assert moe.capacity(cfg, t) == jmoe.capacity(jcfg, t)
    moonshot = configs.get_config("moonshot-v1-16b-a3b")
    assert moe.capacity(moonshot, 512) == 64       # one row of 512 tokens


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0],
                         ids=["drops", "dropfree"])
def test_moe_apply_grads_match_jax_grad(capacity_factor):
    """The gradient of <moe_apply(x), r> with respect to x and every param
    against ``jax.grad``."""
    jcfg, cfg = _cfgs(capacity_factor=capacity_factor, moe_shared_ff=48)
    jp, p = _layer(jcfg, seed=3)
    x = _x(40, 64, seed=4, common=3.0)
    r = _x(40, 64, seed=5)

    def jloss(params, xx):
        return jnp.sum(jmoe.moe_apply(params, jcfg, xx) * r)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, paths = tree_flatten(p)
    live = [a.clone().requires_grad_(True) for a in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_apply(tree_unflatten(paths, live), cfg, xt)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                live + [xt])
    _assert_close(grads[-1], jgx)
    for g, jg in zip(grads[:-1], jax.tree.leaves(jgp)):
        _assert_close(g, jg)


def test_moe_init_shapes_and_scales_match_reference():
    jcfg, cfg = _cfgs(moe_shared_ff=48)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    jl, pl = jax.tree.leaves(jp), tree_flatten(p)[0]
    assert [tuple(a.shape) for a in pl] == [b.shape for b in jl]
    for a, b in zip(pl, jl):
        assert a.dtype == torch.float32
        assert abs(float(a.std()) / float(np.asarray(b).std()) - 1) < 0.1


# --------------------------------------------------------------------------
# moe_apply_serve
# --------------------------------------------------------------------------

def _serve_dispatch(active, algorithm, p_shards, torch_side=True):
    if torch_side:
        return moe.ServeDispatch(
            active=active, p_shards=p_shards,
            exchange=lambda parts: exchange_activation_spmd(parts, algorithm))
    return jmoe.ServeDispatch(
        active=active, p_shards=p_shards,
        exchange=lambda parts: jax_exchange(parts, algorithm))


@pytest.mark.parametrize("p_shards", [2, 4])
def test_moe_apply_serve_masking_and_exchange(p_shards):
    """Inactive slots take no capacity and receive nothing; the row-stream
    exchange is bit-equal to the dense sum; an active token's output is
    the one a batch of itself alone computes; routing and slot maps are
    the reference's bit for bit, the output within the model tolerance."""
    jcfg, cfg = _cfgs(moe_shared_ff=48)
    jp, p = _layer(jcfg, seed=6)
    x = _x(8, 64, seed=7)
    act = np.zeros(8, bool)
    act[[0, 3, 6]] = True
    xt, at = torch.from_numpy(x), torch.from_numpy(act)
    _, _, jslot_token, c = _reference_slots(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(act))
    _, _, dsp, _ = _port_slots(p, cfg, xt, at)
    assert c == 8
    np.testing.assert_array_equal(dsp.slot_token.numpy(), jslot_token)
    # inactive tokens' assignments all point at the sentinel
    e_c = cfg.num_experts * c
    assert (dsp.token_slots[~at] == e_c).all()
    assert (dsp.token_slots[at] < e_c).all()
    y_dense = moe.moe_apply_serve(p, cfg, xt,
                                  _serve_dispatch(at, "dense", p_shards))
    y_stream = moe.moe_apply_serve(
        p, cfg, xt, _serve_dispatch(at, "stream_gather@4", p_shards))
    assert torch.equal(y_dense, y_stream)
    routed = moe.moe_apply_serve(
        {k: v for k, v in p.items() if k != "shared"},
        ModelConfig(**{**MOE}, dtype=torch.float32,
                    param_dtype=torch.float32), xt,
        _serve_dispatch(at, "dense", p_shards))
    assert not routed[~at].any()
    solo = moe.moe_apply(p, cfg, xt[0:1])
    _assert_close(y_dense[0], solo[0].detach().numpy())
    jy = jmoe.moe_apply_serve(jp, jcfg, jnp.asarray(x), _serve_dispatch(
        jnp.asarray(act), "dense", p_shards, torch_side=False))
    _assert_close(y_dense, jy)


def test_serve_partials_sum_in_the_reference_order():
    """Each shard's partial holds only its experts' rows, each token's
    rows summed in ascending slot order; summed over the shards they give
    the training combine bit for bit (capacity T, nothing dropped)."""
    jcfg, cfg = _cfgs(capacity_factor=4.0)
    _, p = _layer(jcfg, seed=8)
    xt = torch.from_numpy(_x(8, 64, seed=9))
    captured = {}

    def keep(parts):
        captured["parts"] = parts
        return exchange_activation_spmd(parts, "dense")

    at = torch.ones(8, dtype=torch.bool)
    y = moe.moe_apply_serve(p, cfg, xt, moe.ServeDispatch(at, keep, 2))
    parts = captured["parts"]
    assert parts.shape == (2, 8, 64)
    # capacity(cfg, 8) == 8 == T: the training layer packs the same slots
    assert moe.capacity(cfg, 8) == 8
    assert torch.equal(y, moe.moe_apply(p, cfg, xt))
    eidx = moe._route(p, xt, cfg.experts_per_token)[1]
    half = cfg.num_experts // 2
    for s in range(2):
        mine = ((eidx >= s * half) & (eidx < (s + 1) * half)).any(-1)
        assert not parts[s][~mine].any() and parts[s][mine].any(-1).all()


# --------------------------------------------------------------------------
# the model: rank_grads, and both MoE smoke configs against the reference
# --------------------------------------------------------------------------

def test_rank_grads_on_a_moe_model_equal_a_loop_over_ranks():
    """vmap over 4 ranks (2 microbatches each) bit-equal to each rank's
    grads computed alone: the dispatch has no in-place write and no
    cross-rank state."""
    cfg = configs.smoke_config("moonshot-v1-16b-a3b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    loss, grads = rank_grads(model, params, batch, 4, 2)
    losses = []
    for r in range(4):
        l_r, g_r = _accumulated_grads(
            model, params, {k: v[2 * r:2 * r + 2] for k, v in batch.items()},
            2)
        losses.append(l_r)
        for a, b in zip(grads, g_r):
            assert torch.equal(a[r], b)
    assert torch.equal(loss, torch.stack(losses).mean())


def _smoke(arch):
    jcfg, cfg = jax_configs.smoke_config(arch), configs.smoke_config(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, model, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _batch(cfg, seed, b=2, s=16):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


@pytest.mark.parametrize("arch", SMOKES)
def test_smoke_forward_and_train_step_match_reference(arch):
    """Forward logits, the loss and every gradient of one train step of
    the MoE smoke configs (capacity factor 1.25, drops included)."""
    jmodel, jparams, model, params = _smoke(arch)
    jb, tb = _batch(model.cfg, 11)
    logits = model.forward(params, tb)
    assert logits.shape == (2, 16, model.cfg.padded_vocab)
    _assert_close(logits, jmodel.forward(jparams, jb))
    jloss, jgrads = jax.value_and_grad(lambda q: jmodel.loss(q, jb))(jparams)
    leaves, paths = tree_flatten(params)
    live = [a.clone().requires_grad_(True) for a in leaves]
    loss = model.loss(tree_unflatten(paths, live), tb)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _assert_close(g, jg)


@pytest.mark.parametrize("arch", SMOKES)
def test_smoke_prefill_decode_match_reference(arch):
    """Prefill 16 tokens into a cache of 32 and decode 2 steps: logits and
    caches against the reference's (the reference's smoke check, held to
    values)."""
    jmodel, jparams, model, params = _smoke(arch)
    jb, tb = _batch(model.cfg, 12)
    jlg, jst = jmodel.prefill(jparams, {"tokens": jb["tokens"]}, 32)
    lg, st = model.prefill(params, {"tokens": tb["tokens"]}, 32)
    assert lg.shape == (2, model.cfg.padded_vocab)
    _assert_close(lg, jlg)
    for i in range(2):
        tok = tb["tokens"][:, i:i + 1]
        jlg, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok.numpy()))
        lg, st = model.decode_step(params, st, tok)
        _assert_close(lg, jlg)
    assert int(st.pos) == int(jst.pos) == 18
    _assert_close(st.kv.k, jst.kv.k)
