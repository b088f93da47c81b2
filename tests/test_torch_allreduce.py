"""The port's sparse allreduce library (``core/allreduce.py``) and per-rank
executor (``comm/executor.py``) on ``StackedCollectives`` against the JAX
package's on 8 (or 4) emulated host devices.

Tolerances: the algorithms' results allclose at rtol 1e-5, atol 1e-6 (the
reference's own ``tests/test_allreduce.py`` bound; the port in fact sums
in the same order and is bit-equal on these inputs); clamp folds at the
same tolerance; DSAR + QSGD-4 with the same rounding bits bit-equal in
'max' scale mode, and in 'l2' mode an entry may differ by one
quantization level (its bucket's L2 scale summed in another order); the
per-rank executor allclose at rtol 1e-5, atol 1e-6 over two
error-feedback steps.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _telemetry_check import assert_telemetry_close
from jax.sharding import PartitionSpec as P

from repro import comm as jcomm
from repro.comm import executor as jax_exec
from repro.compat import make_mesh, shard_map
from repro.core import allreduce as jar
from repro.core import topk as jax_topk
from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.core.cost_model import select_algorithm as jax_select
from repro.core.qsgd import QSGDConfig as JaxQSGDConfig
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.models.specs import param_specs as jax_param_specs
from repro_torch.comm import executor
from repro_torch.comm.collectives import StackedCollectives
from repro_torch.comm.plan import build_sync_plan
from repro_torch.core import allreduce as ar
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.cost_model import NetworkParams
from repro_torch.core.qsgd import QSGDConfig
from repro_torch.core.topk import compress
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.models.specs import param_specs
from repro_torch.utils.tree import tree_flatten, tree_unflatten

N, B = 8192, 512
ALGOS = ("ssar_recursive_double", "ssar_split_allgather",
         "dsar_split_allgather", "ssar_balanced_split", "ssar_rearranged_rs",
         "dense")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pattern(name, k):
    """The index patterns of tests/test_allreduce.py: disjoint supports
    (the result has k*P nonzeros), identical supports (k nonzeros), and
    random normal data."""
    xs = np.zeros((8, N), np.float32)
    if name == "no_overlap":
        for r in range(8):
            for j in range(k):
                xs[r, j * B + r] = float(r + 1)
    elif name == "full_overlap":
        xs[:, : B * k: B] = 1.0
    else:
        xs = np.random.default_rng(42).standard_normal((8, N)).astype(
            np.float32)
    return xs


def _u32(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32)).view(
        torch.uint32)


@pytest.mark.parametrize("pattern", ["no_overlap", "full_overlap", "random"])
@pytest.mark.parametrize("algo", ALGOS)
def test_make_sparse_allreduce_matches_jax(mesh8, algo, pattern):
    k = 8 if pattern != "random" else 4
    xs = _pattern(pattern, k)
    jf = jar.make_sparse_allreduce(mesh8, "data", N, k, B, algorithm=algo)
    want = np.asarray(jf(jnp.asarray(xs).reshape(-1), None))
    f = ar.make_sparse_allreduce(StackedCollectives(8, device="cpu"), N, k,
                                 B, algorithm=algo)
    got = f(torch.from_numpy(xs)).numpy()
    assert got.shape == (8, N)
    for r in range(8):
        np.testing.assert_allclose(got[r], want, **TOL)
    assert (got == got[:1]).all()       # every rank holds the same sum
    if pattern == "no_overlap" and algo not in ("ssar_balanced_split",
                                                "ssar_rearranged_rs"):
        assert (got[0] != 0).sum() == 8 * k


def test_auto_and_bad_shapes_refused(mesh8):
    """"auto" (the default; the name is kept from when it was refused)
    picks the reference's algorithm on its DEFAULT_NET values, given as
    net, at k = 4 and 64 of 512, and sums as the reference's auto call
    does; without net it raises, as does a shape the context does not
    hold."""
    coll = StackedCollectives(8, device="cpu")
    n = 1 << 15
    xs = np.random.default_rng(3).standard_normal((8, n)).astype(np.float32)
    picked = []
    for k in (4, 64):
        jf = jar.make_sparse_allreduce(mesh8, "data", n, k, B,
                                       algorithm="auto")
        want = np.asarray(jf(jnp.asarray(xs).reshape(-1), None))
        f = ar.make_sparse_allreduce(coll, n, k, B,
                                     net=NetworkParams(1e-6, 50e9))
        assert f.algorithm == jax_select(8, n // B * k, n)
        picked.append(f.algorithm)
        got = f(torch.from_numpy(xs)).numpy()
        for r in range(8):
            np.testing.assert_allclose(got[r], want, **TOL)
    assert picked[0] != picked[1]
    with pytest.raises(ValueError, match="needs network parameters"):
        ar.make_sparse_allreduce(coll, N, 4, B)
    f = ar.make_sparse_allreduce(coll, N, 4, B,
                                 algorithm="dsar_split_allgather")
    with pytest.raises(ValueError, match="ranks"):
        f(torch.zeros(4, N))


CLAMP_K = 16


@functools.lru_cache(maxsize=None)
def _jax_clamped(name):
    """The reference's (replicated result, per-rank fold) on random data,
    computed once per algorithm. Its scatter mode returns the replicated
    result restricted to the owned range and the same fold (bit-equal by
    construction, as its docstrings say), so one compile serves both."""
    mesh8 = make_mesh((8,), ("data",))
    xs = np.random.default_rng(7).standard_normal((8, N)).astype(np.float32)

    def inner(xr):
        u, _ = jax_topk.compress(xr.reshape(-1), CLAMP_K, B, impl="ref")
        out, fold = getattr(jar, name)(u, axis_name="data", p=8)
        return out[None], fold[None]

    f = jax.jit(shard_map(inner, mesh=mesh8, in_specs=(P("data"),),
                          out_specs=(P("data"), P("data")), check_vma=False))
    out, fold = f(jnp.asarray(xs))
    return xs, np.asarray(out), np.asarray(fold)


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("name", ["ssar_balanced_split_inside",
                                  "ssar_rearranged_rs_inside"])
def test_clamped_algorithms_binding_caps(name, scatter):
    """Random data makes both capacity clamps bind: the result and each
    rank's fold match the reference's, and result + sum of folds is the
    exact sum of the 8 ranks' TopK streams (the global-residual rule)."""
    xs, want_out, want_fold = _jax_clamped(name)
    if scatter:
        want_out = np.stack([want_out[r].reshape(8, -1)[r] for r in range(8)])
    u, _ = compress(torch.from_numpy(xs), CLAMP_K, B)
    coll = StackedCollectives(8, device="cpu")
    out, fold = getattr(ar, name)(u, coll=coll, scatter=scatter)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(fold.numpy(), want_fold, **TOL)
    assert np.abs(want_fold).max() > 0, "caps never bound; vacuous"
    exact = u.densify().numpy().astype(np.float64).sum(0)
    total = fold.numpy().astype(np.float64).sum(0)
    total += (out.numpy().reshape(-1) if scatter else out.numpy()[0])
    np.testing.assert_allclose(total, exact, rtol=1e-5,
                               atol=1e-6 * np.abs(exact).max())


@pytest.mark.parametrize("mode", ["max", "l2"])
def test_dsar_qsgd4_same_bits(mesh8, mode):
    k = 4
    xs = np.random.default_rng(5).standard_normal((8, N)).astype(np.float32)
    rand = np.random.default_rng(6).integers(
        0, 2**32, size=(8, N), dtype=np.uint64).astype(np.uint32)
    jf = jar.make_sparse_allreduce(mesh8, "data", N, k, B,
                                   algorithm="dsar_split_allgather",
                                   qsgd=JaxQSGDConfig(4, 1024, mode))
    want = np.asarray(jf(jnp.asarray(xs).reshape(-1),
                         jnp.asarray(rand).reshape(-1)))
    f = ar.make_sparse_allreduce(StackedCollectives(8, device="cpu"), N, k,
                                 B, algorithm="dsar_split_allgather",
                                 qsgd=QSGDConfig(4, 1024, mode))
    got = f(torch.from_numpy(xs), _u32(rand)).numpy()
    assert (got == got[:1]).all()
    exact = compress(torch.from_numpy(xs), k, B)[0].densify().numpy().sum(0)
    if mode == "max":
        np.testing.assert_array_equal(got[0], want)
    else:
        # one level of a 4-bit code is sigma/7, sigma the bucket's L2 norm
        sigma = np.sqrt((exact.reshape(-1, 1024).astype(np.float64) ** 2)
                        .sum(1))
        step = np.repeat(sigma / 7, 1024)
        diff = np.abs(got[0] - want)
        assert (diff <= step * 1.001 + 1e-6).all()
        assert (diff > 0).mean() < 0.02
    # the reference's own bound (tests/test_allreduce.py)
    mask = np.abs(exact) > 0
    rel = np.abs(got[0] - exact)[mask].mean() / np.abs(exact)[mask].mean()
    assert rel < 0.5


def test_recursive_double_switches_to_dense_past_delta():
    """At k = 64 of 512 the |H1|+|H2| bound crosses delta in round 2 of 3
    (the Fig. 3 case, scaled down): the result is dense and exact."""
    n, k = 1 << 15, 64
    xs = np.random.default_rng(1).standard_normal((8, n)).astype(np.float32)
    u, _ = compress(torch.from_numpy(xs), k, B)
    coll = StackedCollectives(8, device="cpu")
    out = ar.ssar_recursive_double_inside(u.to_stream(), coll=coll, n=n)
    assert out.stream is None and out.dense is not None
    small = ar.ssar_recursive_double_inside(
        compress(torch.from_numpy(xs), 4, B)[0].to_stream(), coll=coll, n=n)
    assert small.dense is None and small.stream.capacity == 8 * (n // B) * 4
    exact = u.densify().numpy().astype(np.float64).sum(0)
    np.testing.assert_allclose(out.dense.numpy()[3], exact, rtol=1e-5,
                               atol=1e-6 * np.abs(exact).max())


def test_recursive_double_dense_tail_matches_jax(mesh8):
    """The same k = 64 case through both packages' make_sparse_allreduce:
    the reference switches to its dense tail in the same round, and the
    results agree at TOL."""
    n, k = 1 << 15, 64
    xs = np.random.default_rng(1).standard_normal((8, n)).astype(np.float32)
    jf = jar.make_sparse_allreduce(mesh8, "data", n, k, B,
                                   algorithm="ssar_recursive_double")
    want = np.asarray(jf(jnp.asarray(xs).reshape(-1), None))
    f = ar.make_sparse_allreduce(StackedCollectives(8, device="cpu"), n, k,
                                 B, algorithm="ssar_recursive_double")
    got = f(torch.from_numpy(xs)).numpy()
    for r in range(8):
        np.testing.assert_allclose(got[r], want, **TOL)


# --------------------------------------------------------------------------
# the per-rank executor against the reference's under shard_map
# --------------------------------------------------------------------------

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)


def _plans(algo, qsgd_bits, p):
    kw = dict(mode="sparcml", k_per_bucket=4, bucket_size=128, algorithm=algo,
              qsgd_bits=qsgd_bits, qsgd_bucket=128, min_sparse_size=256)
    jcfg = JaxModelConfig(**TINY, dtype=jnp.float32, param_dtype=jnp.float32)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    jplan = jcomm.build_sync_plan(jshapes, jax_param_specs(jshapes, jcfg, None),
                                  JaxSyncConfig(**kw, impl="ref"), p)
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    plan = build_sync_plan(shapes, param_specs(shapes, cfg), SyncConfig(**kw),
                           p)
    assert [b.algorithm for b in plan.buckets] == \
        [b.algorithm for b in jplan.buckets]
    return jplan, plan, tree_flatten(shapes)[0]


EXEC_CASES = [("dsar", "dsar_split_allgather", None, (1, 4)),
              ("dsar_qsgd4", "dsar_split_allgather", 4, (1, 4)),
              ("split_allgather", "ssar_split_allgather", None, (1, 4)),
              ("recursive_double", "ssar_recursive_double", None, (1, 4)),
              ("balanced", "ssar_balanced_split", None, (1, 4)),
              ("rearranged", "ssar_rearranged_rs", None, (1, 4)),
              ("raw_dense", "dense", None, (1, 4)),
              ("dsar_qsgd4_pods", "dsar_split_allgather", 4, (2, 2)),
              ("split_allgather_pod_sparse", "ssar_split_allgather", None,
               (2, 2))]


@pytest.mark.parametrize("name,algo,bits,grid", EXEC_CASES,
                         ids=[c[0] for c in EXEC_CASES])
def test_execute_plan_matches_jax_manual(name, algo, bits, grid):
    p_pod, p_data = grid
    R = p_pod * p_data
    jplan, plan, leaves = _plans(algo, bits, R)
    if name.endswith("pod_sparse"):
        flat = [b.name for b in plan.buckets if b.rows == 1]
        jplan = jplan.replan(algorithms={b.name: b.algorithm
                                         for b in jplan.buckets},
                             pod_sparse={nm: True for nm in flat})
        plan = dataclasses.replace(plan, groups=tuple(
            dataclasses.replace(g, buckets=tuple(
                dataclasses.replace(b, pod_sparse=b.name in flat)
                for b in g.buckets)) for g in plan.groups))
    key = jax.random.PRNGKey(3)
    if p_pod > 1:
        mesh = make_mesh((p_pod, p_data), ("pod", "data"))
        dp, kw = ("pod", "data"), dict(pod_axis="pod", p_pod=p_pod)
    else:
        mesh = make_mesh((p_data,), ("data",))
        dp, kw = "data", {}
    jres = {n: jnp.zeros(s.shape, s.dtype)
            for n, s in jplan.residual_shapes().items()}
    rspecs = {n: P(dp, None, None) for n in jres}
    lspec = [P(dp) for _ in leaves]
    rid = jnp.arange(R, dtype=jnp.int32)

    def inner(gs, res, rid, k):
        data_rank = rid[0] % p_data
        pod_rank = rid[0] // p_data if p_pod > 1 else None
        out, new_res = jax_exec.execute_plan(
            jplan, [g[0] for g in gs], res, k, data_axis="data",
            p_data=p_data, native=True, data_rank=data_rank,
            pod_rank=pod_rank, **kw)
        return out, new_res

    jf = jax.jit(shard_map(inner, mesh=mesh,
                           in_specs=(lspec, rspecs, P(dp), P()),
                           out_specs=([P() for _ in leaves], rspecs),
                           check_vma=False))
    coll = StackedCollectives(p_data, outer=p_pod, device="cpu")
    pod_coll = (StackedCollectives(p_pod, inner=p_data, device="cpu")
                if p_pod > 1 else None)
    res = plan.init_residuals()
    rng = np.random.default_rng(len(name))
    for step in range(2):
        grads = [rng.standard_normal((R,) + tuple(l.shape)).astype(np.float32)
                 for l in leaves]
        skey = jax.random.fold_in(key, step)

        def rand_fn(bucket_idx, n, skey=skey):
            bits_ = jax_exec._qsgd_rand_all(skey, bucket_idx, p_pod, p_data,
                                            n // R)
            return _u32(np.asarray(bits_).reshape(-1))

        jout, jres = jf([jnp.asarray(g) for g in grads], jres, rid, skey)
        out, res = executor.execute_plan(
            plan, [torch.from_numpy(g) for g in grads], res, coll=coll,
            pod_coll=pod_coll, rand_fn=rand_fn)
        for a, b in zip(out, jout):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        for n in res:
            np.testing.assert_allclose(res[n].numpy(), np.asarray(jres[n]),
                                       **TOL)


def test_reduce_buckets_refuses_telemetry_and_wrong_grids():
    """Telemetry is ported: a row for every EF bucket, none when off.
    Grids that do not match the plan or the leaves are refused."""
    _, plan, leaves = _plans("dsar_split_allgather", None, 4)
    grads = [torch.zeros((4,) + tuple(l.shape)) for l in leaves]
    res = plan.init_residuals()
    coll = StackedCollectives(4, device="cpu")
    _, _, tel = executor.reduce_buckets(plan, grads, res, coll=coll)
    assert set(tel) == {b.name for b in plan.buckets if b.sparse}
    assert all(row.shape == (4, 4) for row in tel.values())
    _, _, none = executor.reduce_buckets(plan, grads, res, coll=coll,
                                         telemetry=False)
    assert none == {}
    with pytest.raises(ValueError, match="ranks"):
        executor.reduce_buckets(
            plan, grads, res,
            coll=StackedCollectives(2, outer=2, device="cpu"))


def _grid(p_pod, p_data):
    """(mesh, dp axes, reference kwargs, data ctx, pod ctx, R)."""
    if p_pod > 1:
        return (make_mesh((p_pod, p_data), ("pod", "data")), ("pod", "data"),
                dict(pod_axis="pod", p_pod=p_pod),
                StackedCollectives(p_data, outer=p_pod, device="cpu"),
                StackedCollectives(p_pod, inner=p_data, device="cpu"),
                p_pod * p_data)
    return (make_mesh((p_data,), ("data",)), "data", {},
            StackedCollectives(p_data, device="cpu"), None, p_data)


def _reference_rand_fn(skey, p_pod, p_data):
    def rand_fn(bucket_idx, n):
        bits_ = jax_exec._qsgd_rand_all(skey, bucket_idx, p_pod, p_data,
                                        n // (p_pod * p_data))
        return _u32(np.asarray(bits_).reshape(-1))
    return rand_fn


@pytest.mark.parametrize("name,algo,bits,grid", EXEC_CASES,
                         ids=[c[0] for c in EXEC_CASES])
def test_reduce_buckets_telemetry_matches_jax_manual(name, algo, bits, grid):
    """The per-rank reduce half with telemetry on, over two
    error-feedback steps: every rank's row against the reference's
    (shard_map, one extra psum a bucket for the mass terms), and the
    same buffers and residuals as with telemetry off."""
    p_pod, p_data = grid
    mesh, dp, kw, coll, pod_coll, R = _grid(p_pod, p_data)
    jplan, plan, leaves = _plans(algo, bits, R)
    if name.endswith("pod_sparse"):
        flat = [b.name for b in plan.buckets if b.rows == 1]
        jplan = jplan.replan(algorithms=jplan.algorithms(),
                             pod_sparse={nm: True for nm in flat})
        plan = dataclasses.replace(plan, groups=tuple(
            dataclasses.replace(g, buckets=tuple(
                dataclasses.replace(b, pod_sparse=b.name in flat)
                for b in g.buckets)) for g in plan.groups))
    jres = {n: jnp.zeros(s.shape, s.dtype)
            for n, s in jplan.residual_shapes().items()}
    rspecs = {n: P(dp, None, None) for n in jres}
    rid = jnp.arange(R, dtype=jnp.int32)

    def inner(gs, res, rid, k):
        _, new_res, tel = jax_exec.reduce_buckets(
            jplan, [g[0] for g in gs], res, k, data_axis="data",
            p_data=p_data, native=True, data_rank=rid[0] % p_data,
            pod_rank=rid[0] // p_data if p_pod > 1 else None, telemetry=True,
            **kw)
        return new_res, tel

    jf = jax.jit(shard_map(inner, mesh=mesh,
                           in_specs=([P(dp) for _ in leaves], rspecs, P(dp),
                                     P()),
                           out_specs=(rspecs, {n: P() for n in jres}),
                           check_vma=False))
    res = plan.init_residuals()
    rng = np.random.default_rng(len(name) + 70)
    for step in range(2):
        grads = [torch.from_numpy(rng.standard_normal(
            (R,) + tuple(l.shape)).astype(np.float32)) for l in leaves]
        skey = jax.random.fold_in(jax.random.PRNGKey(11), step)
        rand_fn = _reference_rand_fn(skey, p_pod, p_data)
        jres, jtel = jf([jnp.asarray(g.numpy()) for g in grads], jres, rid,
                        skey)
        reduced, new_res, tel = executor.reduce_buckets(
            plan, grads, res, coll=coll, pod_coll=pod_coll, rand_fn=rand_fn)
        if not plan.num_sparse_buckets:             # raw-dense: no rows
            assert tel == {} and not jtel
        for r in range(R if tel else 0):
            assert_telemetry_close({n: v[r] for n, v in tel.items()}, jtel,
                                   bits is not None)
        off, off_res, none = executor.reduce_buckets(
            plan, grads, res, coll=coll, pod_coll=pod_coll, rand_fn=rand_fn,
            telemetry=False)
        assert none == {} and list(off) == list(reduced)
        for n in reduced:
            assert torch.equal(off[n], reduced[n])
        for n in new_res:
            assert torch.equal(off_res[n], new_res[n])
        res = new_res


# --------------------------------------------------------------------------
# the per-leaf library surface: sync_grads_inside
# --------------------------------------------------------------------------

SYNC_LEAF_CASES = [("dsar_qsgd4", "dsar_split_allgather", 4, (1, 4)),
                   ("split_allgather", "ssar_split_allgather", None, (1, 4)),
                   ("dsar_qsgd4_pods", "dsar_split_allgather", 4, (2, 2))]


@pytest.mark.parametrize("name,algo,bits,grid", SYNC_LEAF_CASES,
                         ids=[c[0] for c in SYNC_LEAF_CASES])
def test_sync_grads_inside_matches_jax(name, algo, bits, grid):
    """The per-leaf wrapper over two error-feedback steps: covered leaves
    through a one-leaf-per-bucket plan, the rest summed densely."""
    from repro.core import compressor as jax_compressor
    from repro_torch.core import compressor

    p_pod, p_data = grid
    mesh, dp, kw, coll, pod_coll, R = _grid(p_pod, p_data)
    sync = dict(mode="sparcml", k_per_bucket=2, bucket_size=32,
                algorithm=algo, qsgd_bits=bits, qsgd_bucket=32,
                min_sparse_size=1024)
    jcfg = JaxModelConfig(**TINY, dtype=jnp.float32, param_dtype=jnp.float32)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    jspecs = jax_param_specs(jshapes, jcfg, None)
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    specs = param_specs(shapes, cfg)
    jsync, tsync = JaxSyncConfig(**sync, impl="ref"), SyncConfig(**sync)
    jres = jax_compressor.init_residuals(jshapes, jspecs, jsync, R)
    res = compressor.init_residuals(shapes, specs, tsync, R)
    flat_j, tdef = jax.tree_util.tree_flatten(jres,
                                              is_leaf=lambda x: x is None)
    assert any(r is None for r in flat_j) and any(r is not None
                                                  for r in flat_j)
    res_specs = tdef.unflatten([None if r is None else P(dp, None, None)
                                for r in flat_j])
    gspecs = jax.tree.map(lambda _: P(dp), jshapes)
    rid = jnp.arange(R, dtype=jnp.int32)

    def inner(g, r, rid, k):
        g = jax.tree.map(lambda x: x[0], g)
        return jax_compressor.sync_grads_inside(
            g, r, k, jsync, jspecs, data_axis="data", p_data=p_data,
            native=True, data_rank=rid[0] % p_data,
            pod_rank=rid[0] // p_data if p_pod > 1 else None, **kw)

    jf = jax.jit(shard_map(inner, mesh=mesh,
                           in_specs=(gspecs, res_specs, P(dp), P()),
                           out_specs=(jax.tree.map(lambda _: P(), jshapes),
                                      res_specs),
                           check_vma=False))
    leaves, paths = tree_flatten(shapes)
    rng = np.random.default_rng(len(name) + 90)
    for step in range(2):
        grads = [rng.standard_normal((R,) + tuple(l.shape)).astype(np.float32)
                 for l in leaves]
        skey = jax.random.fold_in(jax.random.PRNGKey(13), step)
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jshapes),
            [jnp.asarray(g) for g in grads])
        jout, jres = jf(jg, jres, rid, skey)
        out, res = compressor.sync_grads_inside(
            tree_unflatten(paths, [torch.from_numpy(g) for g in grads]), res,
            tsync, specs, coll=coll, pod_coll=pod_coll,
            rand_fn=_reference_rand_fn(skey, p_pod, p_data))
        for a, b in zip(tree_flatten(out)[0], jax.tree.leaves(jout)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        want_res = jax.tree_util.tree_flatten(jres,
                                              is_leaf=lambda x: x is None)[0]
        for a, b in zip(tree_flatten(res)[0], want_res):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
