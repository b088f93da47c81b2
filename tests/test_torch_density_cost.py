"""The port's density model and alpha-beta cost model against the JAX
package's, with the reference's network values passed explicitly to both
(the port keeps no default network constants).

Integer results are exact; floating results agree to rel 1e-12 (the two
are the same host arithmetic, so they are in fact equal).
"""
import math
from types import SimpleNamespace

import pytest

from repro.core import cost_model as jcm
from repro.core import density as jden
from repro_torch.core import cost_model as cm
from repro_torch.core import density as den

JNET = jcm.NetworkParams(alpha=1e-6, link_bytes_per_s=50e9, isize=4)
NET = cm.NetworkParams(alpha=JNET.alpha, link_bytes_per_s=JNET.link_bytes_per_s,
                       isize=JNET.isize)
GRID = [(8, 128, 1 << 15), (8, 1600, 1 << 18), (4, 64, 4096),
        (1024, 1 << 17, 1 << 20), (16, 5000, 1 << 16), (2, 1, 512)]
REL = 1e-12


def _close(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    if isinstance(a, int) and isinstance(b, int):
        assert a == b
        return
    assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0), (a, b)


def test_network_params_have_no_default_link():
    with pytest.raises(TypeError):
        cm.NetworkParams()
    assert not hasattr(cm, "DEFAULT_NET")
    _close((NET.beta_d, NET.beta_s), (JNET.beta_d, JNET.beta_s))


@pytest.mark.parametrize("p,k,n", GRID)
def test_density_functions(p, k, n):
    _close(den.expected_nnz(k, n, p), jden.expected_nnz(k, n, p))
    _close(den.expected_nnz_inclusion_exclusion(k, n, min(p, 64)),
           jden.expected_nnz_inclusion_exclusion(k, n, min(p, 64)))
    _close(den.reduced_density(k, n, p), jden.reduced_density(k, n, p))
    _close(den.fill_in_factor(k, n, p), jden.fill_in_factor(k, n, p))


def test_monte_carlo_uses_the_explicit_seed():
    for seed in (0, 3):
        _close(den.monte_carlo_nnz(16, 1000, 4, trials=3, seed=seed),
               jden.monte_carlo_nnz(16, 1000, 4, trials=3, seed=seed))


@pytest.mark.parametrize("p,k,n", GRID)
@pytest.mark.parametrize("nnz", [None, 200.0, 20000.0])
def test_time_formulas(p, k, n, nnz):
    _close(cm.t_dense_allreduce(p, n, NET), jcm.t_dense_allreduce(p, n, JNET))
    for fn in ("t_ssar_recursive_double", "t_ssar_split_allgather",
               "t_ssar_balanced_split", "t_ssar_rearranged_rs"):
        _close(getattr(cm, fn)(p, k, n, NET, reduced_nnz=nnz),
               getattr(jcm, fn)(p, k, n, JNET, reduced_nnz=nnz))
    for bits in (2, 4, 8, 32):
        _close(cm.t_dsar_split_allgather(p, k, n, NET, bits),
               jcm.t_dsar_split_allgather(p, k, n, JNET, bits))
    _close(cm.t_param_allgather(p, n, NET), jcm.t_param_allgather(p, n, JNET))
    _close(cm.t_stream_allgather(p, 64, 256, NET),
           jcm.t_stream_allgather(p, 64, 256, JNET))


@pytest.mark.parametrize("p,k,n", GRID)
def test_caps_and_integer_accounting(p, k, n):
    assert cm.balanced_shard_cap(k, p, n) == jcm.balanced_shard_cap(k, p, n)
    assert cm.balanced_shard_cap(k, p) == jcm.balanced_shard_cap(k, p)
    assert cm.rearranged_round_caps(k, n, p) == jcm.rearranged_round_caps(
        k, n, p)
    for name in jcm.ALL_ALGORITHMS:
        assert cm.algorithm_output_cap(name, p, k, n) == \
            jcm.algorithm_output_cap(name, p, k, n)
    _close(cm.stream_wire_bytes(p, 64, 256), jcm.stream_wire_bytes(p, 64, 256))
    _close(cm.dsar_speedup_cap(n), jcm.dsar_speedup_cap(n))
    for sparse in (False, True):
        _close(cm.pod_wire_bytes(4, n, k, pod_sparse=sparse),
               jcm.pod_wire_bytes(4, n, k, pod_sparse=sparse))
    assert cm.parse_stream_cap("stream_gather@64") == 64
    with pytest.raises(ValueError, match="stream"):
        cm.parse_stream_cap("stream_gather@0")


def test_registry_matches():
    assert cm.ALL_ALGORITHMS == jcm.ALL_ALGORITHMS
    for name, e in jcm.ALGORITHM_REGISTRY.items():
        t = cm.ALGORITHM_REGISTRY[name]
        assert (t.sparse_result, t.scatter_capable,
                t.output_cap_fn is None) == (e.sparse_result,
                                             e.scatter_capable,
                                             e.output_cap_fn is None)


@pytest.mark.parametrize("p,k,n", GRID)
@pytest.mark.parametrize("scattered", [False, True])
def test_bucket_time_and_wire(p, k, n, scattered):
    for name in jcm.ALL_ALGORITHMS + ("stream_gather@32",):
        for nnz in (None, 100.0, float(n)):
            _close(cm.bucket_time(name, p, k, n, NET, 4, reduced_nnz=nnz,
                                  scattered=scattered),
                   jcm.bucket_time(name, p, k, n, JNET, 4, reduced_nnz=nnz,
                                   scattered=scattered))
            _close(cm.bucket_wire_bytes(name, p, k, n, nnz=nnz, value_bits=4,
                                        scattered=scattered),
                   jcm.bucket_wire_bytes(name, p, k, n, nnz=nnz, value_bits=4,
                                         scattered=scattered))
    with pytest.raises(ValueError, match="unknown"):
        cm.bucket_time("nope", p, k, n, NET)


# the cases of tests/test_portfolio.py::test_select_algorithm_picks_modeled_argmin
@pytest.mark.parametrize("case", [
    (8, 128, 1 << 15, None),
    (8, 1600, 1 << 18, None),
    (1024, 1 << 17, 1 << 20, None),
    (8, 2048, 1 << 15, 20000.0),
    (8, 1600, 1 << 18, 200.0),
])
@pytest.mark.parametrize("scattered", [False, True])
def test_select_algorithm_matches(case, scattered):
    p, k, n, nnz = case
    for bits in (4, 32):
        got = cm.select_algorithm(p, k, n, NET, bits, reduced_nnz=nnz,
                                  scattered=scattered)
        assert got == jcm.select_algorithm(p, k, n, JNET, bits,
                                           reduced_nnz=nnz,
                                           scattered=scattered)
    allow = ("dsar_split_allgather", "dense")
    assert cm.select_bucket_algorithm(p, k, n, NET, allow=allow,
                                      reduced_nnz=nnz) == \
        jcm.select_bucket_algorithm(p, k, n, JNET, allow=allow,
                                    reduced_nnz=nnz)


def test_plan_and_overlap_functions():
    """plan_bucket_times on a duck-typed plan, the exposure model."""
    cfg = SimpleNamespace(qsgd_bits=4, bucket_size=512, k_per_bucket=8)
    buckets = [SimpleNamespace(name=f"b{i}", algorithm=a, n=r * c, cols=c)
               for i, (a, r, c) in enumerate([("dsar_split_allgather", 4, 4096),
                                              ("ssar_split_allgather", 1, 8192),
                                              ("dense", 1, 2048)])]
    group = SimpleNamespace(rows=1, buckets=buckets)

    def bucket_k(g, b):
        return b.n // cfg.bucket_size * cfg.k_per_bucket

    plan = SimpleNamespace(cfg=cfg, dp_total=8, groups=[group],
                           bucket_k=bucket_k, scattered=False)
    dens = {"b1": 300.0}
    _close(cm.plan_bucket_times(plan, None, NET, dens),
           jcm.plan_bucket_times(plan, None, JNET, dens))
    times = [3e-3, 1e-3, 2e-3]
    for overlap in (0.0, 2.5e-3, 1.0):
        _close(cm.exposed_bucket_times(times, overlap),
               jcm.exposed_bucket_times(times, overlap))
        for st in (0, 1):
            _close(cm.t_step_overlapped(overlap, times, st),
                   jcm.t_step_overlapped(overlap, times, st))
