"""The port's compression core, sync plan and stacked-replica executor
against the JAX package.

Tolerances: ``compress2d`` and the plan geometry are bit-equal / equal
field by field; the executor's reduced leaves and new residuals are
allclose(rtol=1e-5, atol=1e-6) — the sum over ranks may be taken in
another order. QSGD rounding bits are the reference's own
``_qsgd_rand_all`` bits, fed to the port through ``rand_fn``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _telemetry_check import assert_telemetry_close

from repro.comm import executor as jax_exec
from repro.comm.plan import build_sync_plan as jax_build_plan
from repro.core import qsgd as jax_qsgd
from repro.core import topk as jax_topk
from repro.core.qsgd import QSGDConfig as JaxQSGDConfig
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.models.specs import param_specs as jax_param_specs
from repro.comm.plan import build_per_leaf_plan as jax_build_per_leaf_plan
from repro.core import compressor as jax_compressor
from repro_torch.comm.executor import execute_plan_spmd, reduce_buckets_spmd
from repro_torch.comm.plan import build_per_leaf_plan, build_sync_plan
from repro_torch.core import compressor
from repro_torch.core import qsgd, topk
from repro_torch.core.qsgd import QSGDConfig
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.cost_model import NetworkParams
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.models.specs import param_specs
from repro_torch.utils.tree import tree_flatten

P_DATA = 4
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
LM100M = dict(name="lm-100m", family="dense", num_layers=12, d_model=768,
              num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
              max_seq_len=1024)
# the MoE smoke configs (configs/moonshot_v1_16b_a3b.py, configs/dbrx_132b.py)
MOONSHOT_SMOKE = dict(name="moonshot", family="moe", num_layers=4, d_model=64,
                      num_heads=4, num_kv_heads=4, head_dim=16, d_ff=32,
                      vocab_size=512, num_experts=8, experts_per_token=2,
                      moe_d_ff=32, moe_shared_ff=64, max_seq_len=128)
DBRX_SMOKE = dict(name="dbrx", family="moe", num_layers=4, d_model=64,
                  num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=512, num_experts=4, experts_per_token=2,
                  moe_d_ff=128, max_seq_len=128)


# --------------------------------------------------------------------------
# compress2d
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lead,cols,b,k", [((4, 3), 1024, 512, 8),
                                           ((2, 5), 512, 128, 4),
                                           ((6,), 256, 128, 16)])
def test_compress2d_matches_jax(lead, cols, b, k):
    rng = np.random.default_rng(cols + k)
    x = rng.standard_normal(lead + (cols,)).astype(np.float32)
    x[0, ..., :b] = np.round(x[0, ..., :b])       # magnitude ties
    u, res = topk.compress2d(torch.from_numpy(x), k, b)
    ju, jres = jax_topk.compress2d(jnp.asarray(x), k, b)
    np.testing.assert_array_equal(u.lidx.numpy(), np.asarray(ju.lidx))
    np.testing.assert_array_equal(u.val.numpy(), np.asarray(ju.val))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(u.densify().numpy(),
                                  np.asarray(ju.densify()))


def test_qsgd_quantize_dequantize_match_jax():
    """The flat-vector QSGD API, padding included (n not a bucket
    multiple); 'max' scale, so bit-equal."""
    rng = np.random.default_rng(9)
    n = 1000
    x = rng.standard_normal(n).astype(np.float32)
    rand = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    cfg = QSGDConfig(4, 256, "max")
    packed, scale = qsgd.quantize(torch.from_numpy(x), cfg,
                                  torch.from_numpy(rand))
    jp, js = jax_qsgd.quantize(jnp.asarray(x), JaxQSGDConfig(4, 256, "max"),
                               jnp.asarray(rand))
    np.testing.assert_array_equal(packed.view(torch.int32).numpy(),
                                  np.asarray(jp).view(np.int32))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    xhat = qsgd.dequantize(packed, scale, cfg, n)
    jxhat = jax_qsgd.dequantize(jp, js, JaxQSGDConfig(4, 256, "max"), n)
    assert xhat.shape == (n,)
    np.testing.assert_array_equal(xhat.numpy(), np.asarray(jxhat))


def test_compress_flat_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(1000).astype(np.float32)
    u, res = topk.compress(torch.from_numpy(x), 4, 128)
    ju, jres = jax_topk.compress(jnp.asarray(x), 4, 128)
    np.testing.assert_array_equal(u.lidx.numpy(), np.asarray(ju.lidx))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(u.densify().numpy(),
                                  np.asarray(ju.densify()))


# --------------------------------------------------------------------------
# build_sync_plan, shape only: eval_shape on the JAX side, meta tensors here
# --------------------------------------------------------------------------

def _sync_kwargs(**kw):
    base = dict(mode="sparcml", k_per_bucket=8, bucket_size=512,
                algorithm="dsar_split_allgather", qsgd_bits=4,
                min_sparse_size=65536)
    base.update(kw)
    return base


def _plans(model_kw, net=None, **sync_kw):
    jcfg = JaxModelConfig(**model_kw, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    jmodel = jax_build_model(jcfg)
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jspecs = jax_param_specs(jshapes, jcfg, None)
    jplan = jax_build_plan(jshapes, jspecs, JaxSyncConfig(**sync_kw), P_DATA)

    cfg = ModelConfig(**model_kw, dtype=torch.float32,
                      param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    plan = build_sync_plan(shapes, param_specs(shapes, cfg),
                           SyncConfig(**sync_kw), P_DATA, net)
    return jplan, plan, jshapes, shapes


def _assert_plans_equal(jplan, plan):
    assert plan.dp_total == jplan.dp_total
    assert plan.num_leaves == jplan.num_leaves
    assert len(plan.groups) == len(jplan.groups)
    for g, jg in zip(plan.groups, jplan.groups):
        assert (g.gid, g.rows, g.model_sharded, g.cols) == \
            (jg.gid, jg.rows, jg.model_sharded, jg.cols)
        assert len(g.slots) == len(jg.slots)
        for s, js in zip(g.slots, jg.slots):
            assert (s.leaf_id, s.shape, s.rows, s.cols, s.offset) == \
                (js.leaf_id, tuple(js.shape), js.rows, js.cols, js.offset)
            assert tuple(s.spec) == tuple(js.spec)
        assert [(b.name, b.col_start, b.cols, b.rows, b.algorithm,
                 b.sparse) for b in g.buckets] == \
            [(b.name, b.col_start, b.cols, b.rows, b.algorithm,
              b.has_residual) for b in jg.buckets]


@pytest.mark.parametrize("model_kw,sync_kw", [
    (TINY, _sync_kwargs(bucket_size=128, qsgd_bucket=128,
                        min_sparse_size=1024)),
    (TINY, _sync_kwargs(bucket_size=128, qsgd_bits=None,
                        min_sparse_size=1024, fusion_bucket_bytes=1 << 16)),
    (LM100M, _sync_kwargs()),
    (MOONSHOT_SMOKE, _sync_kwargs(k_per_bucket=4)),
    (DBRX_SMOKE, _sync_kwargs(k_per_bucket=4)),
])
def test_build_sync_plan_matches_jax(model_kw, sync_kw):
    jplan, plan, jshapes, shapes = _plans(model_kw, **sync_kw)
    _assert_plans_equal(jplan, plan)
    # the flatten order the plan's leaf ids index
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    assert tree_flatten(shapes)[1] == jpaths


def test_lm100m_plan_geometry():
    """The slice's configuration: 27 buckets, 26 sparse DSAR buckets of
    4096 columns, 239,075,328 top-k entries per replica."""
    _, plan, _, _ = _plans(LM100M, **_sync_kwargs())
    assert plan.num_buckets == 27 and plan.num_sparse_buckets == 26
    assert [g.rows for g in plan.groups] == [1, 256, 768, 2048, 32768]
    sparse = [b for b in plan.buckets if b.sparse]
    assert {b.cols for b in sparse} == {4096}
    assert sum(b.n for b in sparse) == 239_075_328
    dense = [b for b in plan.buckets if not b.sparse]
    assert [(b.name, b.rows, b.cols) for b in dense] == [("g0b0", 1, 20480)]


def test_auto_algorithm_is_not_ported():
    """"auto" (ported since: the name is kept) resolves every bucket as
    the reference does on its DEFAULT_NET, given those values as net;
    without net it raises and says what to pass."""
    kw = _sync_kwargs(bucket_size=128, qsgd_bucket=128, min_sparse_size=1024,
                      algorithm="auto")
    jplan, plan, _, _ = _plans(TINY, net=NetworkParams(1e-6, 50e9), **kw)
    _assert_plans_equal(jplan, plan)
    assert plan.num_sparse_buckets > 0
    with pytest.raises(ValueError, match="needs network parameters"):
        _plans(TINY, **kw)


# --------------------------------------------------------------------------
# execute_plan_spmd over 2 error-feedback steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,sync_kw", [
    ("dense_only", _sync_kwargs(bucket_size=128, qsgd_bits=None,
                                min_sparse_size=1 << 30)),
    ("dsar", _sync_kwargs(bucket_size=128, k_per_bucket=4, qsgd_bits=None,
                          min_sparse_size=1024)),
    ("dsar_qsgd4", _sync_kwargs(bucket_size=128, k_per_bucket=4,
                                qsgd_bucket=128, min_sparse_size=1024)),
    ("dsar_qsgd4_pods", _sync_kwargs(bucket_size=128, k_per_bucket=4,
                                     qsgd_bucket=128, min_sparse_size=1024)),
])
def test_execute_plan_spmd_matches_jax(name, sync_kw):
    # (p_pod, p_data): the pods case splits the same 4 replicas 2 x 2
    p_pod, p_data = (2, 2) if name.endswith("_pods") else (1, P_DATA)
    jplan, plan, jshapes, shapes = _plans(TINY, **sync_kw)
    leaves, _ = tree_flatten(shapes)
    rng = np.random.default_rng(len(name))
    key = jax.random.PRNGKey(3)

    jres = {n: jnp.zeros(s.shape, s.dtype)
            for n, s in jplan.residual_shapes().items()}
    res = plan.init_residuals()
    if name == "dense_only":
        assert not res and not jres
    else:
        assert set(res) == set(jres) and res

    @jax.jit
    def jax_step(leaves_r, residuals, k):
        return jax_exec.execute_plan_spmd(jplan, leaves_r, residuals, k,
                                          p_data=p_data, p_pod=p_pod)

    for step in range(2):
        grads = [rng.standard_normal((P_DATA,) + tuple(leaf.shape))
                 .astype(np.float32) for leaf in leaves]
        skey = jax.random.fold_in(key, step)

        def rand_fn(bucket_idx, n, skey=skey):
            bits = jax_exec._qsgd_rand_all(skey, bucket_idx, p_pod, p_data,
                                           n // P_DATA)
            return torch.from_numpy(np.array(bits).reshape(-1))

        jout, jres = jax_step([jnp.asarray(g) for g in grads], jres, skey)
        out, res = execute_plan_spmd(
            plan, [torch.from_numpy(g) for g in grads], res, p_data=p_data,
            p_pod=p_pod, rand_fn=rand_fn)
        for a, b in zip(out, jout):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        assert set(res) == set(jres)
        for n in res:
            np.testing.assert_allclose(res[n].numpy(), np.asarray(jres[n]),
                                       rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the plan's accounting, the per-leaf plan and the wire report
# --------------------------------------------------------------------------

ACCOUNTING_CASES = [
    ("tiny_dsar_qsgd4", TINY, _sync_kwargs(bucket_size=128, qsgd_bucket=128,
                                           min_sparse_size=1024)),
    ("tiny_split_allgather", TINY, _sync_kwargs(
        bucket_size=128, qsgd_bits=None, min_sparse_size=1024,
        algorithm="ssar_split_allgather", fusion_bucket_bytes=1 << 16)),
    ("tiny_rearranged", TINY, _sync_kwargs(
        bucket_size=128, qsgd_bits=None, min_sparse_size=1024,
        algorithm="ssar_rearranged_rs")),
    ("lm100m", LM100M, _sync_kwargs()),
]


@pytest.mark.parametrize("name,model_kw,sync_kw", ACCOUNTING_CASES,
                         ids=[c[0] for c in ACCOUNTING_CASES])
def test_plan_accounting_matches_jax(name, model_kw, sync_kw):
    jplan, plan, _, _ = _plans(model_kw, **sync_kw)
    for p in (None, 2, 8):
        for agg in (False, True):
            assert plan.wire_bytes(p, aggregate=agg) == pytest.approx(
                jplan.wire_bytes(p, aggregate=agg), rel=1e-12)
            assert plan.param_allgather_bytes(p, aggregate=agg) == \
                jplan.param_allgather_bytes(p, aggregate=agg) == 0.0
    assert plan.algorithms() == jplan.algorithms()
    assert plan.pod_sparse_flags() == jplan.pod_sparse_flags()
    assert plan.signature() == jplan.signature()
    assert plan.covered_leaf_ids() == jplan.covered_leaf_ids()


def _assert_per_leaf_plans_equal(model_kw, sync_kw, p):
    jcfg = JaxModelConfig(**model_kw, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    jplan = jax_build_per_leaf_plan(jshapes, jax_param_specs(jshapes, jcfg,
                                                             None),
                                    JaxSyncConfig(**sync_kw), p)
    cfg = ModelConfig(**model_kw, dtype=torch.float32,
                      param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    plan = build_per_leaf_plan(shapes, param_specs(shapes, cfg),
                               SyncConfig(**sync_kw), p)
    _assert_plans_equal(jplan, plan)
    return plan, jplan


# per-leaf routing needs every row's bucket count to split over the
# ranks: the tiny model's leaves qualify at B = 32
PER_LEAF_CASES = [
    ("tiny_dsar_qsgd4", TINY, _sync_kwargs(
        bucket_size=32, k_per_bucket=2, qsgd_bucket=32,
        min_sparse_size=1024)),
    ("tiny_split_allgather", TINY, _sync_kwargs(
        bucket_size=32, k_per_bucket=2, qsgd_bits=None, min_sparse_size=1024,
        algorithm="ssar_split_allgather")),
    ("lm100m", LM100M, _sync_kwargs()),
]


@pytest.mark.parametrize("name,model_kw,sync_kw", PER_LEAF_CASES,
                         ids=[c[0] for c in PER_LEAF_CASES])
def test_build_per_leaf_plan_matches_jax(name, model_kw, sync_kw):
    plan, jplan = _assert_per_leaf_plans_equal(model_kw, sync_kw, P_DATA)
    assert plan.num_buckets > 0
    assert plan.covered_leaf_ids() == jplan.covered_leaf_ids()
    assert plan.wire_bytes() == pytest.approx(jplan.wire_bytes(), rel=1e-12)


def _shape_trees(model_kw):
    jcfg = JaxModelConfig(**model_kw, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    cfg = ModelConfig(**model_kw, dtype=torch.float32,
                      param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    return (jshapes, jax_param_specs(jshapes, jcfg, None), shapes,
            param_specs(shapes, cfg))


@pytest.mark.parametrize("name,model_kw,sync_kw", PER_LEAF_CASES + [
    ("tiny_dense_mode", TINY, dict(mode="dense"))],
    ids=[c[0] for c in PER_LEAF_CASES] + ["tiny_dense_mode"])
def test_wire_bytes_per_step_matches_jax(name, model_kw, sync_kw):
    """Per leaf (with and without specs), per bucket of the fused plan,
    and in dense mode."""
    jshapes, jspecs, shapes, specs = _shape_trees(model_kw)
    jcfg, cfg = JaxSyncConfig(**sync_kw), SyncConfig(**sync_kw)
    for p in (2, P_DATA):
        for with_specs in (False, True):
            want = jax_compressor.wire_bytes_per_step(
                jshapes, jcfg, p, jspecs if with_specs else None)
            got = compressor.wire_bytes_per_step(
                shapes, cfg, p, specs if with_specs else None)
            assert got == pytest.approx(want, rel=1e-12)
    if cfg.mode == "sparcml":
        jplan = jax_build_plan(jshapes, jspecs, jcfg, P_DATA)
        plan = build_sync_plan(shapes, specs, cfg, P_DATA)
        assert compressor.wire_bytes_per_step(
            shapes, cfg, P_DATA, specs, plan=plan) == pytest.approx(
            jax_compressor.wire_bytes_per_step(jshapes, jcfg, P_DATA, jspecs,
                                               plan=jplan), rel=1e-12)


@pytest.mark.parametrize("name,model_kw,sync_kw", PER_LEAF_CASES[:2],
                         ids=[c[0] for c in PER_LEAF_CASES[:2]])
def test_per_leaf_residual_trees_match_jax(name, model_kw, sync_kw):
    jshapes, jspecs, shapes, specs = _shape_trees(model_kw)
    jcfg, cfg = JaxSyncConfig(**sync_kw), SyncConfig(**sync_kw)
    want = jax.tree_util.tree_flatten(
        jax_compressor.residual_shapes(jshapes, jspecs, jcfg, P_DATA),
        is_leaf=lambda x: x is None)[0]
    got = tree_flatten(compressor.residual_shapes(shapes, specs, cfg,
                                                  P_DATA))[0]
    assert [None if s is None else tuple(s.shape) for s in got] == \
        [None if s is None else tuple(s.shape) for s in want]
    assert any(s is not None for s in got) and any(s is None for s in got)
    zeros = tree_flatten(compressor.init_residuals(shapes, specs, cfg,
                                                   P_DATA))[0]
    assert [None if z is None else (tuple(z.shape), bool(z.any()))
            for z in zeros] == [None if s is None else (tuple(s.shape), False)
                                for s in got]
    jrs = jax.tree_util.tree_flatten(
        jax_compressor.residual_specs(jshapes, jspecs, jcfg, P_DATA),
        is_leaf=lambda x: x is None)[0]
    rs = tree_flatten(compressor.residual_specs(shapes, specs, cfg, P_DATA))[0]
    assert [None if s is None else tuple(s) for s in rs] == \
        [None if s is None else tuple(s) for s in jrs]
    assert [compressor.sparse_path_ok(tuple(l.shape), sp, cfg, P_DATA)
            for l, sp in zip(tree_flatten(shapes)[0],
                             tree_flatten(specs)[0])] == \
        [s is not None for s in got]


# --------------------------------------------------------------------------
# the stacked executor's telemetry rows
# --------------------------------------------------------------------------

TELEMETRY_CASES = [
    ("dsar", _sync_kwargs(bucket_size=128, k_per_bucket=4, qsgd_bits=None,
                          min_sparse_size=1024), (1, P_DATA)),
    ("dsar_qsgd4", _sync_kwargs(bucket_size=128, k_per_bucket=4,
                                qsgd_bucket=128, min_sparse_size=1024),
     (1, P_DATA)),
    ("dsar_qsgd4_pods", _sync_kwargs(bucket_size=128, k_per_bucket=4,
                                     qsgd_bucket=128, min_sparse_size=1024),
     (2, 2)),
    ("split_allgather", _sync_kwargs(bucket_size=128, k_per_bucket=4,
                                     qsgd_bits=None, min_sparse_size=1024,
                                     algorithm="ssar_split_allgather"),
     (1, P_DATA)),
]


@pytest.mark.parametrize("name,sync_kw,grid", TELEMETRY_CASES,
                         ids=[c[0] for c in TELEMETRY_CASES])
def test_reduce_buckets_spmd_telemetry_matches_jax(name, sync_kw, grid):
    """Two error-feedback steps of the reduce half with telemetry on, the
    rows against the reference's; off, no rows and the same buffers."""
    p_pod, p_data = grid
    jplan, plan, _, shapes = _plans(TINY, **sync_kw)
    leaves, _ = tree_flatten(shapes)
    rng = np.random.default_rng(len(name) + 40)
    key = jax.random.PRNGKey(5)
    jres = {n: jnp.zeros(s.shape, s.dtype)
            for n, s in jplan.residual_shapes().items()}
    res = plan.init_residuals()

    @jax.jit
    def jax_reduce(leaves_r, residuals, k):
        return jax_exec.reduce_buckets_spmd(jplan, leaves_r, residuals, k,
                                            p_data=p_data, p_pod=p_pod,
                                            telemetry=True)

    for step in range(2):
        grads = [torch.from_numpy(rng.standard_normal(
            (P_DATA,) + tuple(leaf.shape)).astype(np.float32))
            for leaf in leaves]
        skey = jax.random.fold_in(key, step)

        def rand_fn(bucket_idx, n, skey=skey):
            bits = jax_exec._qsgd_rand_all(skey, bucket_idx, p_pod, p_data,
                                           n // P_DATA)
            return torch.from_numpy(np.array(bits).reshape(-1))

        _, jres, jtel = jax_reduce([jnp.asarray(g.numpy()) for g in grads],
                                   jres, skey)
        reduced, new_res, tel = reduce_buckets_spmd(
            plan, grads, res, p_data=p_data, p_pod=p_pod, rand_fn=rand_fn)
        assert_telemetry_close(tel, jtel, sync_kw["qsgd_bits"] is not None)
        assert set(tel) == {b.name for b in plan.buckets if b.sparse}
        off, off_res, none = reduce_buckets_spmd(
            plan, grads, res, p_data=p_data, p_pod=p_pod, rand_fn=rand_fn,
            telemetry=False)
        assert none == {}
        assert list(off) == list(reduced) == [b.name for b in plan.buckets]
        for n in reduced:
            assert torch.equal(off[n], reduced[n])
        for n in new_res:
            assert torch.equal(off_res[n], new_res[n])
        res = new_res


# --------------------------------------------------------------------------
# the stacked executor against the per-rank one, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qsgd_bits", [None, 4])
@pytest.mark.parametrize("grid", [(1, 4), (2, 2), (1, 8), (2, 4)],
                         ids=["R4", "R4_pods", "R8", "R8_pods"])
def test_reduce_buckets_spmd_bit_equal_to_per_rank(grid, qsgd_bits):
    """Both executors' reduce halves over two error-feedback steps (DSAR,
    with and without 4-bit QSGD, raw-dense buckets too) on the same
    gradients and rounding bits: the same reduced buffers (every held
    rank's) and residuals, bit for bit. The stacked form's fused densify
    sums each pod's ranks in rank order and then the pods, as the
    per-rank form's data-axis and pod collectives do."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.comm.executor import reduce_buckets

    p_pod, p_data = grid
    R = p_pod * p_data
    kw = _sync_kwargs(bucket_size=128, k_per_bucket=4, qsgd_bits=qsgd_bits,
                      qsgd_bucket=128, min_sparse_size=2048)
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    plan = build_sync_plan(shapes, param_specs(shapes, cfg),
                           SyncConfig(**kw), R)
    assert plan.num_sparse_buckets and len(plan.buckets) > \
        plan.num_sparse_buckets
    leaves, _ = tree_flatten(shapes)
    coll = StackedCollectives(p_data, outer=p_pod, device="cpu")
    pod_coll = (StackedCollectives(p_pod, inner=p_data, device="cpu")
                if p_pod > 1 else None)
    rng = np.random.default_rng(R + 10 * p_pod + (qsgd_bits or 0))

    def rand_fn(bucket_idx, n):
        return torch.from_numpy(np.random.default_rng(bucket_idx).integers(
            0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))

    res_s = res_r = plan.init_residuals()
    for _ in range(2):
        grads = [torch.from_numpy(rng.standard_normal(
            (R,) + tuple(l.shape)).astype(np.float32)) for l in leaves]
        red_s, res_s, _ = reduce_buckets_spmd(
            plan, grads, res_s, p_data=p_data, p_pod=p_pod, rand_fn=rand_fn,
            telemetry=False)
        red_r, res_r, _ = reduce_buckets(
            plan, grads, res_r, coll=coll, pod_coll=pod_coll,
            rand_fn=rand_fn, telemetry=False)
        assert list(red_s) == list(red_r) == [b.name for b in plan.buckets]
        for nm, buf in red_s.items():
            assert red_r[nm].shape == (R,) + tuple(buf.shape)
            for r in range(R):
                assert torch.equal(red_r[nm][r], buf), (nm, r)
        assert list(res_s) == list(res_r)
        for nm in res_s:
            assert torch.equal(res_s[nm], res_r[nm]), nm
