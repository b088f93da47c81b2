"""The port's sparse streams (``core/sparse_stream.py``) and
``UniformStream.to_stream`` against the JAX package.

Inputs come from numpy seeds: streams with duplicate indices across
streams, SENTINEL padding and capacities that overflow. Tolerances:
indices and nnz bit-equal everywhere; values bit-equal in merges of two
streams (each run of an index summed left to right from zero, as the
reference's CPU scatter does) and in every pure data movement, allclose
at rtol 1e-6 where a densify adds duplicates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_stream as jss
from repro.core import topk as jax_topk
from repro_torch.core import sparse_stream as ss
from repro_torch.core.topk import UniformStream

N = 4096


def _stream(rng, cap, nnz, n=N, lo=0, hi=None):
    """Sorted numpy stream of ``nnz`` distinct indices in [lo, hi),
    SENTINEL-padded to ``cap``; values exactly representable or not."""
    hi = n if hi is None else hi
    idx = np.full(cap, ss.SENTINEL, np.int32)
    val = np.zeros(cap, np.float32)
    pick = np.sort(rng.choice(np.arange(lo, hi), size=nnz, replace=False))
    idx[:nnz] = pick
    val[:nnz] = rng.standard_normal(nnz).astype(np.float32)
    return idx, val, np.int32(nnz)


def _both(idx, val, nnz):
    t = ss.SparseStream(torch.from_numpy(np.array(idx)),
                        torch.from_numpy(np.array(val)),
                        torch.as_tensor(np.array(nnz)))
    j = jss.SparseStream(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(nnz))
    return t, j


def _equal(t, j, values="equal"):
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.nnz.numpy(), np.asarray(j.nnz))
    if values == "equal":
        np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
    else:
        np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val),
                                   rtol=1e-6, atol=1e-7)


def test_constants_and_integer_helpers():
    assert ss.SENTINEL == int(jss.SENTINEL)
    assert ss.INDEX_BYTES == jss.INDEX_BYTES
    for n in (1, 7, 4096, 1 << 24):
        for isize in (2, 4, 8):
            assert ss.delta_threshold(n, isize) == jss.delta_threshold(n, isize)
    for x in (0, 1, 2, 3, 5, 64, 65, 1000):
        assert ss.round_up_pow2(x) == jss.round_up_pow2(x)
    t, j = ss.empty(7), jss.empty(7)
    _equal(t, j)
    assert ss.empty(5, lead=(3,)).idx.shape == (3, 5)


@pytest.mark.parametrize("k", [1, 16, 300])
def test_from_dense_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal(1000).astype(np.float32)
    x[::5] = np.round(x[::5])                       # magnitude ties
    _equal(ss.from_dense_topk(torch.from_numpy(x), k),
           jss.from_dense_topk(jnp.asarray(x), k))


@pytest.mark.parametrize("cap", [50, 200, 1000])
def test_from_mask_matches_jax_including_overflow(cap):
    rng = np.random.default_rng(cap)
    x = rng.standard_normal(1000).astype(np.float32)
    mask = rng.random(1000) < 0.1                    # ~100 set: cap 50 overflows
    _equal(ss.from_mask(torch.from_numpy(x), torch.from_numpy(mask), cap),
           jss.from_mask(jnp.asarray(x), jnp.asarray(mask), cap))


def test_densify_drops_sentinels_and_adds_duplicates():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 300, size=500).astype(np.int32)  # duplicates
    idx[::7] = ss.SENTINEL
    val = rng.standard_normal(500).astype(np.float32)
    t, j = _both(idx, val, 500)
    np.testing.assert_allclose(ss.densify(t, 300).numpy(),
                               np.asarray(jss.densify(j, 300)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cap_a,nnz_a,cap_b,nnz_b,cap_out", [
    (64, 40, 64, 50, 128),      # room for the union
    (64, 64, 32, 20, 70),       # the union overflows cap_out
    (16, 0, 16, 9, 32),         # an empty stream
])
def test_merge_two_streams_bit_equal(cap_a, nnz_a, cap_b, nnz_b, cap_out):
    rng = np.random.default_rng(cap_out + nnz_a)
    a = _stream(rng, cap_a, nnz_a, n=200)            # dense overlap in 200
    b = _stream(rng, cap_b, nnz_b, n=200)
    (ta, ja), (tb, jb) = _both(*a), _both(*b)
    _equal(ss.merge(ta, tb, cap_out), jss.merge(ja, jb, cap_out))


def test_merge_runs_longer_than_the_bound():
    """A stream with duplicate indices inside it: runs of up to 6 equal
    indices; run_bound=2 still sums them (the tail in the device's
    order), run_bound=6 sums them in the reference's order."""
    rng = np.random.default_rng(11)
    idx = np.sort(rng.integers(0, 40, size=120)).astype(np.int32)
    val = rng.standard_normal(120).astype(np.float32)
    (ta, ja) = _both(idx, val, 120)
    (tb, jb) = _both(*_stream(rng, 30, 25, n=60))
    want = jss.merge(ja, jb, 64)
    _equal(ss.merge(ta, tb, 64, run_bound=2), want, values="allclose")
    _equal(ss.merge(ta, tb, 64, run_bound=8), want)


def test_merge_batched_rows_match_per_row():
    rng = np.random.default_rng(5)
    rows_a = [_stream(rng, 48, int(rng.integers(0, 48)), n=150)
              for _ in range(4)]
    rows_b = [_stream(rng, 48, int(rng.integers(0, 48)), n=150)
              for _ in range(4)]
    stack = lambda rows: ss.SparseStream(*(torch.from_numpy(np.stack(c))
                                           for c in zip(*rows)))
    got = ss.merge(stack(rows_a), stack(rows_b), 60)
    for r, (a, b) in enumerate(zip(rows_a, rows_b)):
        want = jss.merge(_both(*a)[1], _both(*b)[1], 60)
        _equal(ss.SparseStream(got.idx[r], got.val[r], got.nnz[r]), want)


@pytest.mark.parametrize("cap_out", [None, 90, 40])
def test_concat_disjoint_ranges(cap_out):
    rng = np.random.default_rng(17)
    parts = [_stream(rng, 32, 25, lo=lo, hi=lo + 100)
             for lo in (200, 0, 500)]                 # out of order
    t = ss.concat([_both(*p)[0] for p in parts], cap_out)
    j = jss.concat([_both(*p)[1] for p in parts], cap_out)
    _equal(t, j)


def test_pad_to_grows_and_refuses_to_shrink():
    rng = np.random.default_rng(2)
    t, j = _both(*_stream(rng, 20, 12))
    _equal(ss.pad_to(t, 33), jss.pad_to(j, 33))
    assert ss.pad_to(t, 20) is t
    with pytest.raises(ValueError, match="shrink"):
        ss.pad_to(t, 10)


def test_uniform_stream_to_stream_and_counts():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(8 * 128).astype(np.float32)
    from repro_torch.core.topk import compress

    u, _ = compress(torch.from_numpy(x), 4, 128)
    ju, _ = jax_topk.compress(jnp.asarray(x), 4, 128, impl="ref")
    assert (u.n, u.nnz, u.k, u.num_buckets) == (ju.n, ju.nnz, ju.k,
                                               ju.num_buckets)
    _equal(u.to_stream(), ju.to_stream())
    # a leading rank axis rides along
    ub = UniformStream(u.lidx.expand(3, -1, -1), u.val.expand(3, -1, -1), 128)
    s3 = ub.to_stream()
    assert s3.idx.shape == (3, 32) and s3.nnz.tolist() == [32] * 3
    assert torch.equal(s3.idx[2], u.to_stream().idx)
