"""The port's kernel wrappers against the JAX package's kernels.

Each plain PyTorch version (what a CPU tensor runs) is held against the
Pallas kernel (interpret mode on the CPU, ``impl="pallas"``) and the jnp
oracle (``impl="ref"``) on the same numpy inputs. Tolerances: bit-equal,
except
  * bucket_scatter with duplicate indices: allclose(rtol=0, atol=1e-6)
    — the one-hot contraction sums duplicates in another order (so does
    bucket_scatter_sum, whose sources are summed in order in numpy from
    the JAX package's densify of each);
  * qsgd_pack in 'l2' mode: the order of the σ sum may move σ by ulps,
    so σ is allclose(rtol=1e-6) and a code may differ by one level on at
    most 1e-4 of the entries (at least one entry).
The grouped unpack is held bit for bit to the JAX package's unpack,
transpose, pod sum and mean run op by op as ``reduce_buckets_spmd``
writes them. (Under ``jax.jit`` XLA-CPU contracts a two-pod sum into an
FMA, one rounding fewer, so the jitted executor agrees only to an ulp.)
The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py`` (on a card) and by ``chip_smoke.py``; the radix
select of ``csrc/bucket_topk.cu`` is also modelled here in numpy, so that a
mistake in its digit passes or its tie rule shows on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bucket_scatter.ops import bucket_scatter as jax_scatter
from repro.kernels.bucket_topk.ops import bucket_topk as jax_topk
from repro.kernels.qsgd_pack.ops import qsgd_pack as jax_pack
from repro.kernels.qsgd_unpack.ops import qsgd_unpack as jax_unpack
from repro_torch.kernels.bucket_scatter import ops as scatter_ops
from repro_torch.kernels.bucket_scatter.ref import ScatterSumSegment
from repro_torch.kernels.bucket_topk import ops as topk_ops
from repro_torch.kernels.bucket_topk.cases import adversarial_rows
from repro_torch.kernels.bucket_topk.kernel import (require_supported_b,
                                                    supported_b)
from repro_torch.kernels.qsgd_pack import ops as pack_ops
from repro_torch.kernels.qsgd_pack.ref import PackSegment, u32_to_i64
from repro_torch.kernels.qsgd_unpack import ops as unpack_ops
from repro_torch.kernels.qsgd_unpack.ref import UnpackSegment

JAX_IMPLS = ("ref", "pallas")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x_with_ties(seed, nb, b):
    """Gaussian rows plus rows full of magnitude ties and a zero row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, b)).astype(np.float32)
    x[0] = 1.0                                        # every entry ties
    if nb > 1:
        x[1, 1::2] = -x[1, ::2]                       # pairs of equal |x|
    if nb > 2:
        x[2] = np.round(x[2])                         # few distinct values
    if nb > 3:
        x[3] = 0.0                                    # all-zero bucket
    return x


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


# --------------------------------------------------------------------------
# bucket_topk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nb,b,k", [(8, 128, 4), (16, 512, 8), (6, 256, 16),
                                    (3, 512, 16), (8, 128, 1), (5, 512, 64),
                                    (4, 128, 128), (3, 1024, 128)])
def test_bucket_topk_plain_matches_jax(nb, b, k):
    """Rows with ties, then rows of one magnitude with mixed signs, of
    +0.0 and -0.0, with a few infinities and of infinities only."""
    adv = adversarial_rows(2, b, seed=nb + k)
    x = np.concatenate([_x_with_ties(nb * 131 + k, nb, b)] + [
        adv[name].numpy() for name in ("one_magnitude", "signed_zeros",
                                       "infinities", "all_infinite")])
    val, lidx, res = topk_ops.bucket_topk(torch.from_numpy(x), k)
    assert lidx.dtype == torch.int32
    for impl in JAX_IMPLS:
        jv, jl, jr = jax_topk(jnp.asarray(x), k, impl=impl)
        np.testing.assert_array_equal(lidx.numpy(), np.asarray(jl), impl)
        np.testing.assert_array_equal(val.numpy(), np.asarray(jv), impl)
        np.testing.assert_array_equal(res.numpy(), np.asarray(jr), impl)


def _radix_select_model(x: np.ndarray, k: int):
    """``csrc/bucket_topk.cu``'s selection, row by row in numpy: digit
    passes over the 31-bit key (the bits of |x|: 30-23, 22-15, 14-7, 6-0),
    each a histogram of the keys that match the prefix found so far, the
    bin of the k-th key from the top found by a suffix sum, an early stop
    when that bin holds exactly the keys still needed; then every key above
    the bin and the lowest-indexed ``need`` inside it. Returns (val, lidx,
    res) and the number of passes each row took."""
    keys = (x.view(np.uint32) & 0x7FFFFFFF).astype(np.int64)
    sel = np.zeros(x.shape, bool)
    passes = []
    for r, key in enumerate(keys):
        prefix, need, low = 0, k, 31
        for p, shift in enumerate((23, 15, 7, 0)):
            cand = (key >> low) == (prefix >> low)
            hist = np.bincount((key[cand] >> shift) & ((1 << (low - shift)) - 1),
                               minlength=256)
            from_top = np.cumsum(hist[::-1])[::-1]   # keys in bin d and above
            digit = int(np.flatnonzero(from_top >= need)[-1])
            need -= int(from_top[digit] - hist[digit])
            prefix |= digit << shift
            low = shift
            if hist[digit] == need:
                break
        passes.append(p + 1)
        top = prefix | ((1 << low) - 1)
        in_bin = (key >> low) == (prefix >> low)
        rank = np.cumsum(in_bin) - in_bin            # in index order
        sel[r] = (key > top) | (in_bin & (rank < need))
    return _selected(x, sel), passes


def _threshold_rule(x: np.ndarray, k: int):
    """T = the k-th largest key of the row; every key above T, then the
    lowest indices among the keys equal to T."""
    keys = (x.view(np.uint32) & 0x7FFFFFFF).astype(np.int64)
    sel = np.zeros(x.shape, bool)
    for r, key in enumerate(keys):
        t = np.sort(key)[::-1][k - 1]
        eq = key == t
        sel[r] = (key > t) | (eq & (np.cumsum(eq) <= k - (key > t).sum()))
    return _selected(x, sel)


def _selected(x, sel):
    lidx = np.stack([np.flatnonzero(s) for s in sel]).astype(np.int32)
    return (np.take_along_axis(x, lidx, 1), lidx,
            np.where(sel, np.float32(0), x))


def _topk_cases():
    return [(b, k) for b in (128, 256, 384, 512, 640, 1024)
            for k in sorted({1, 4, 8, 64, b // 2, b})]


@pytest.mark.parametrize("b,k", _topk_cases())
def test_bucket_topk_radix_model_matches_plain(b, k):
    """The kernel's radix select and its tie rule, modelled in numpy, and
    the plain threshold rule, against the plain version, bit for bit
    (signed zeros included), on Gaussian rows with ties and on every
    adversarial row set."""
    rng = np.random.default_rng(b + k)
    x = np.concatenate([_x_with_ties(b * k, 4, b),
                        rng.standard_normal((4, b)).astype(np.float32)] + [
        rows.numpy() for rows in adversarial_rows(3, b, seed=k).values()])
    want = topk_ops.bucket_topk(torch.from_numpy(x), k)
    got, passes = _radix_select_model(x, k)
    assert max(passes) <= 4
    for model in (got, _threshold_rule(x, k)):
        for g, w in zip(model, want):
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.numpy().view(np.int32))


def _block_select_model(x: np.ndarray, k: int, threads: int = 256):
    """``csrc/bucket_topk.cu``'s one-block-a-row form (B > 1024) in numpy,
    step by step: the same digit passes, the 256-bin suffix sum taken as
    the kernel takes it (within each warp of 32 bins, then the totals of
    the higher warps added) and the bin found as the one whose suffix
    reaches ``need`` while the bins above it do not; then the selection in
    chunks of ``threads`` keys in index order, where a key's rank among the
    tied keys and its output position are its warp's ballot prefix plus
    the counts of the chunk's lower warps and of every earlier chunk.
    Returns (val, lidx, res) from the positions it writes."""
    keys = (x.view(np.uint32) & 0x7FFFFFFF).astype(np.int64)
    n_rows, b = x.shape
    warps = threads // 32
    val = np.zeros((n_rows, k), np.float32)
    lidx = np.full((n_rows, k), -1, np.int32)
    res = x.copy()
    for r, key in enumerate(keys):
        prefix, need, low = 0, k, 31
        for shift in (23, 15, 7, 0):
            cand = (key >> low) == (prefix >> low)
            digits = (key[cand] >> shift) & ((1 << (low - shift)) - 1)
            hist = np.bincount(digits, minlength=256)
            lanes = hist.reshape(warps, 32)
            incl = np.cumsum(lanes[:, ::-1], axis=1)[:, ::-1]
            totals = incl[:, 0]
            incl = (incl + (np.cumsum(totals[::-1])[::-1] - totals)[:, None]
                    ).reshape(-1)
            found = np.flatnonzero((incl >= need) & (incl - hist < need))
            assert found.size == 1
            d = int(found[0])
            need -= int(incl[d] - hist[d])
            prefix |= d << shift
            low = shift
            if hist[d] == need:
                break
        top = prefix | ((1 << low) - 1)
        tied = taken = 0
        for base in range(0, b, threads):
            i = base + np.arange(threads)
            live = i < b
            kk = key[np.minimum(i, b - 1)]
            in_bin = live & ((kk >> low) == (prefix >> low))
            tie = in_bin.reshape(warps, 32)
            tie_rank = (tied + (np.cumsum(tie.sum(1)) - tie.sum(1))[:, None]
                        + np.cumsum(tie, axis=1) - tie).reshape(-1)
            s = live & ((kk > top) | (in_bin & (tie_rank < need)))
            sel = s.reshape(warps, 32)
            pos = (taken + (np.cumsum(sel.sum(1)) - sel.sum(1))[:, None]
                   + np.cumsum(sel, axis=1) - sel).reshape(-1)
            val[r, pos[s]] = x[r, i[s]]
            lidx[r, pos[s]] = i[s]
            res[r, i[s]] = 0.0
            tied += int(tie.sum())
            taken += int(sel.sum())
        assert taken == k
    return val, lidx, res


@pytest.mark.parametrize("b,k", [(b, k) for b in (2048, 8192)
                                 for k in sorted({1, 8, b // 64, b // 2, b})])
def test_bucket_topk_block_model_matches_plain(b, k):
    """The one-block-a-row form above B = 1024, modelled in numpy with its
    chunked tie rule, against the plain version bit for bit on Gaussian
    rows with ties and on every adversarial row set."""
    rng = np.random.default_rng(b + k)
    x = np.concatenate([_x_with_ties(b * k, 4, b),
                        rng.standard_normal((2, b)).astype(np.float32)] + [
        rows.numpy() for rows in adversarial_rows(2, b, seed=k).values()])
    want = topk_ops.bucket_topk(torch.from_numpy(x), k)
    for g, w in zip(_block_select_model(x, k), want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


def test_bucket_topk_b_limit():
    """Every multiple of 128 up to 8192 and nothing else; the plain
    version takes any B."""
    assert [b for b in range(1, 9000) if supported_b(b)] == list(
        range(128, 8193, 128))
    with pytest.raises(ValueError, match="multiple of 128 up to 8192"):
        require_supported_b(1000)
    x = torch.randn(3, 1000)
    assert topk_ops.bucket_topk(x, 5)[1].shape == (3, 5)


# --------------------------------------------------------------------------
# bucket_scatter
# --------------------------------------------------------------------------

def _distinct_lidx(rng, nb, b, k):
    return np.sort(np.stack([rng.choice(b, size=k, replace=False)
                             for _ in range(nb)]), axis=1).astype(np.int32)


@pytest.mark.parametrize("nb,b,k", [(8, 128, 4), (16, 512, 8), (5, 256, 16)])
def test_bucket_scatter_plain_matches_jax_distinct(nb, b, k):
    rng = np.random.default_rng(nb + b + k)
    lidx = _distinct_lidx(rng, nb, b, k)
    val = rng.standard_normal((nb, k)).astype(np.float32)
    out = scatter_ops.bucket_scatter(torch.from_numpy(lidx),
                                     torch.from_numpy(val), b)
    for impl in JAX_IMPLS:
        ref = np.asarray(jax_scatter(jnp.asarray(lidx), jnp.asarray(val), b,
                                     impl=impl))
        np.testing.assert_array_equal(out.numpy(), ref, impl)


@pytest.mark.parametrize("nb,b,k", [(8, 128, 8), (12, 512, 16)])
def test_bucket_scatter_plain_duplicates_and_sentinels(nb, b, k):
    rng = np.random.default_rng(7 * nb + k)
    lidx = rng.integers(0, b // 16, size=(nb, k)).astype(np.int32)  # dups
    lidx[rng.random((nb, k)) < 0.2] = b + 5                       # sentinel
    lidx[0] = np.iinfo(np.int32).max
    val = rng.standard_normal((nb, k)).astype(np.float32)
    out = scatter_ops.bucket_scatter(torch.from_numpy(lidx),
                                     torch.from_numpy(val), b).numpy()
    assert not out[0].any()
    for impl in JAX_IMPLS:
        ref = np.asarray(jax_scatter(jnp.asarray(lidx), jnp.asarray(val), b,
                                     impl=impl))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6, err_msg=impl)


def test_bucket_scatter_plain_drops_negative_indices():
    """Negative indices are dropped, as the Pallas kernel's one-hot drops
    them (the jnp oracle would wrap them around)."""
    lidx = torch.tensor([[-1, 3, 3, 9]], dtype=torch.int32)
    val = torch.tensor([[5.0, 1.0, 2.0, 7.0]])
    out = scatter_ops.bucket_scatter(lidx, val, 8)
    expect = torch.zeros(1, 8)
    expect[0, 3] = 3.0
    assert torch.equal(out, expect)


def _jax_scatter_sum(lidx, val, b, impl):
    """The JAX package's densify of each source, summed in source order in
    numpy (float32 adds, ((d0 + d1) + d2) + ...)."""
    g, s, nb, k = lidx.shape
    out = np.zeros((g, nb, b), np.float32)
    for gi in range(g):
        acc = None
        for si in range(s):
            d = np.asarray(jax_scatter(jnp.asarray(lidx[gi, si]),
                                       jnp.asarray(val[gi, si]), b,
                                       impl=impl))
            acc = d.copy() if acc is None else acc + d
        out[gi] = acc
    return out


@pytest.mark.parametrize("g,s,nb,b,k", [(1, 4, 6, 128, 4), (2, 2, 5, 512, 8),
                                        (3, 8, 2, 256, 40)])
def test_bucket_scatter_sum_plain_matches_jax_distinct(g, s, nb, b, k):
    """Distinct indices within each source (top-k's streams): bit-equal,
    and the grouped form equals each segment's own call."""
    rng = np.random.default_rng(g * 100 + s * 10 + k)
    lidx = _distinct_lidx(rng, g * s * nb, b, k).reshape(g, s, nb, k)
    val = rng.standard_normal((g, s, nb, k)).astype(np.float32)
    out = scatter_ops.bucket_scatter_sum(torch.from_numpy(lidx),
                                         torch.from_numpy(val), b)
    assert out.shape == (g, nb, b)
    for impl in JAX_IMPLS:
        np.testing.assert_array_equal(out.numpy(),
                                      _jax_scatter_sum(lidx, val, b, impl),
                                      impl)
    seg = ScatterSumSegment(torch.from_numpy(lidx), torch.from_numpy(val), b)
    other = ScatterSumSegment(seg.lidx[:1, :1], seg.val[:1, :1], b)
    grouped = scatter_ops.bucket_scatter_sum_grouped([other, seg])
    assert torch.equal(grouped[1], out)
    assert torch.equal(grouped[0], scatter_ops.bucket_scatter(
        seg.lidx[0, 0], seg.val[0, 0], b)[None])


@pytest.mark.parametrize("g,s,nb,b,k", [(2, 4, 6, 128, 8), (1, 3, 9, 512, 40)])
def test_bucket_scatter_sum_plain_duplicates_and_sentinels(g, s, nb, b, k):
    """Duplicates and sentinels: allclose to the JAX package's (its one-hot
    contraction adds duplicates in another order), and bit-equal to the
    single-source densify of each source summed in order."""
    rng = np.random.default_rng(3 * g + s + k)
    lidx = rng.integers(0, b // 16, size=(g, s, nb, k)).astype(np.int32)
    lidx[rng.random(lidx.shape) < 0.2] = b + 5
    lidx[0, 0, 0] = np.iinfo(np.int32).max
    val = rng.standard_normal((g, s, nb, k)).astype(np.float32)
    out = scatter_ops.bucket_scatter_sum(torch.from_numpy(lidx),
                                         torch.from_numpy(val), b)
    for impl in JAX_IMPLS:
        np.testing.assert_allclose(out.numpy(),
                                   _jax_scatter_sum(lidx, val, b, impl),
                                   rtol=0, atol=1e-6, err_msg=impl)
    want = np.zeros((g, nb, b), np.float32)
    for gi in range(g):
        for si in range(s):
            want[gi] += scatter_ops.bucket_scatter(
                torch.from_numpy(lidx[gi, si]), torch.from_numpy(val[gi, si]),
                b).numpy()
    np.testing.assert_array_equal(out.numpy(), want)


# --------------------------------------------------------------------------
# qsgd_pack / qsgd_unpack
# --------------------------------------------------------------------------

def _codes(packed_u32: np.ndarray, bits: int) -> np.ndarray:
    vpw = 32 // bits
    p = packed_u32.astype(np.int64)[:, :, None] >> (np.arange(vpw) * bits)
    return (p & (2**bits - 1)).reshape(packed_u32.shape[0], -1)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("mode", ["l2", "max"])
def test_qsgd_pack_plain_matches_jax(bits, mode):
    rng = np.random.default_rng(bits * 10 + len(mode))
    nb, bq = 12, 1024
    x = rng.standard_normal((nb, bq)).astype(np.float32)
    x[3] = 0.0                                   # zero bucket -> code s
    x[5] *= 1e-3
    rand = _u32(rng, (nb, bq))
    packed, scale = pack_ops.qsgd_pack(torch.from_numpy(x),
                                       torch.from_numpy(rand), bits, mode)
    assert packed.dtype == torch.uint32 and packed.shape == (nb, bq * bits // 32)
    codes = _codes(u32_to_i64(packed).numpy(), bits)
    assert (codes[3] == 2 ** (bits - 1) - 1).all()
    for impl in JAX_IMPLS:
        jp, js = jax_pack(jnp.asarray(x), jnp.asarray(rand), bits, mode,
                          impl=impl)
        jcodes = _codes(np.asarray(jp), bits)
        if mode == "max":
            np.testing.assert_array_equal(scale.numpy(), np.asarray(js), impl)
            np.testing.assert_array_equal(codes, jcodes, impl)
        else:
            np.testing.assert_allclose(scale.numpy(), np.asarray(js),
                                       rtol=1e-6, err_msg=impl)
            diff = np.abs(codes - jcodes)
            assert diff.max() <= 1, impl
            assert (diff > 0).sum() <= max(1, math.floor(1e-4 * diff.size)), impl


@pytest.mark.parametrize("mode", ["l2", "max"])
@pytest.mark.parametrize("p_pod,p_data", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_qsgd_pack_grouped_plain_matches_jax(p_pod, p_data, mode):
    """Two buckets' (p_pod, rows, p_data*shard) sums read in place against
    the reference's transpose(0, 2, 1, 3) and qsgd_pack on the same bits
    (``src/repro/comm/executor.py`` reduce_buckets_spmd), at the
    tolerances of test_qsgd_pack_plain_matches_jax; a segment with p_pod =
    p_data = 1 (the per-rank form's) packs its rows in order."""
    bits = 4
    rng = np.random.default_rng(10 * p_pod + p_data + len(mode))
    segs, jax_rows = [], []
    for rows, shard, bq in ((3, 256, 128), (2, 2048, 1024)):
        x = rng.standard_normal((p_pod, rows, p_data * shard)).astype(
            np.float32)
        x[0, 0, :bq] = 0.0                        # a zero QSGD row: code s
        n = x.size
        rand = _u32(rng, (n,))
        segs.append(PackSegment(torch.from_numpy(x), torch.from_numpy(rand),
                                p_pod, p_data, rows, shard, bq))
        jax_rows.append((x.reshape(p_pod, rows, p_data, shard)
                         .transpose(0, 2, 1, 3).reshape(-1, bq),
                         rand.reshape(-1, bq)))
    flat = rng.standard_normal(3 * 256).astype(np.float32)
    frand = _u32(rng, (flat.size,))
    segs.append(PackSegment(torch.from_numpy(flat), torch.from_numpy(frand),
                            1, 1, 3, 256, 256))
    jax_rows.append((flat.reshape(-1, 256), frand.reshape(-1, 256)))
    outs = pack_ops.qsgd_pack_grouped(segs, bits, mode)
    assert len(outs) == len(segs)
    for (packed, scale), (xr, rr) in zip(outs, jax_rows):
        assert packed.shape == (xr.shape[0], xr.shape[1] * bits // 32)
        assert scale.shape == (xr.shape[0], 1)
        codes = _codes(u32_to_i64(packed).numpy(), bits)
        for impl in JAX_IMPLS:
            jp, js = jax_pack(jnp.asarray(xr), jnp.asarray(rr), bits, mode,
                              impl=impl)
            jcodes = _codes(np.asarray(jp), bits)
            if mode == "max":
                np.testing.assert_array_equal(scale.numpy(), np.asarray(js),
                                              impl)
                np.testing.assert_array_equal(codes, jcodes, impl)
            else:
                np.testing.assert_allclose(scale.numpy(), np.asarray(js),
                                           rtol=1e-6, err_msg=impl)
                diff = np.abs(codes - jcodes)
                assert diff.max() <= 1, impl
                assert (diff > 0).sum() <= max(
                    1, math.floor(1e-4 * diff.size)), impl


def test_qsgd_pack_grouped_refuses_bad_geometry():
    """A shard that is no multiple of bq, or sizes that disagree with the
    geometry, raise before any packing."""
    x = torch.zeros(2 * 3 * 256)
    rand = torch.zeros(x.numel(), dtype=torch.uint32)
    good = PackSegment(x, rand, 1, 2, 3, 256, 128)
    with pytest.raises(ValueError, match="multiple of bq"):
        pack_ops.qsgd_pack_grouped([good, good._replace(bq=96)], 4)
    with pytest.raises(ValueError, match="entries"):
        pack_ops.qsgd_pack_grouped([good._replace(rows=2)], 4)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_unpack_plain_matches_jax(bits):
    rng = np.random.default_rng(100 + bits)
    nb, w = 10, 64
    packed = _u32(rng, (nb, w))
    scale = np.abs(rng.standard_normal((nb, 1))).astype(np.float32)
    scale[2] = 0.0
    out = unpack_ops.qsgd_unpack(
        torch.from_numpy(packed), torch.from_numpy(scale), bits)
    for impl in JAX_IMPLS:
        ref = np.asarray(jax_unpack(jnp.asarray(packed), jnp.asarray(scale),
                                    bits, impl=impl))
        np.testing.assert_array_equal(out.numpy(), ref, impl)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_roundtrip_plain_matches_jax(bits):
    rng = np.random.default_rng(200 + bits)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    rand = _u32(rng, x.shape)
    p, s = pack_ops.qsgd_pack(torch.from_numpy(x), torch.from_numpy(rand),
                              bits, "max")
    xhat = unpack_ops.qsgd_unpack(p, s, bits).numpy()
    jp, js = jax_pack(jnp.asarray(x), jnp.asarray(rand), bits, "max",
                      impl="ref")
    ref = np.asarray(jax_unpack(jp, js, bits, impl="ref"))
    np.testing.assert_array_equal(xhat, ref)
    # unbiased rounding: every entry lands on one of its two nearest levels
    step = s.numpy() / (2 ** (bits - 1) - 1)
    assert (np.abs(xhat - x) <= step * (1 + 1e-6)).all()


def _segment(rng, p_pod, p_data, rows, shard, bq, bits, mean):
    nq = p_pod * p_data * rows * (shard // bq)
    packed = _u32(rng, (nq, bq * bits // 32))
    scale = (np.abs(rng.standard_normal((nq, 1))) * rng.uniform(0.01, 100)
             ).astype(np.float32)
    if nq > 2:
        scale[2] = 0.0
    return UnpackSegment(torch.from_numpy(packed), torch.from_numpy(scale),
                         p_pod, p_data, rows, shard, bq, mean)


@pytest.mark.parametrize("mean_is_1_over_r", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("p_pod,p_data", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_qsgd_unpack_grouped_plain_matches_jax(p_pod, p_data, bits,
                                               mean_is_1_over_r):
    """Three buckets of different geometry (shard = bq and 2*bq) against
    the reference's unpack -> transpose(0, 2, 1, 3) -> sum over pods ->
    times the mean (``src/repro/comm/executor.py`` reduce_buckets_spmd)."""
    rng = np.random.default_rng(1000 * p_pod + 100 * p_data + bits)
    mean = 1.0 / (p_pod * p_data) if mean_is_1_over_r else 1.0
    segs = [_segment(rng, p_pod, p_data, rows, shard, bq, bits, mean)
            for rows, shard, bq in ((3, 128, 128), (5, 256, 128),
                                    (2, 128, 64))]
    outs = unpack_ops.qsgd_unpack_grouped(segs, bits)
    assert len(outs) == len(segs)
    for seg, out in zip(segs, outs):
        mb = p_data * seg.shard
        for impl in JAX_IMPLS:
            xq = jax_unpack(jnp.asarray(seg.packed.numpy()),
                            jnp.asarray(seg.scale.numpy()), bits, impl=impl)
            dpod = (xq.reshape(p_pod, p_data, seg.rows, seg.shard)
                    .transpose(0, 2, 1, 3).reshape(p_pod, seg.rows, mb))
            ref = np.asarray(dpod.sum(axis=0) * mean)
            assert out.shape == ref.shape == (seg.rows, mb)
            np.testing.assert_array_equal(out.numpy(), ref, impl)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("held,p_data", [(1, 2), (1, 4), (4, 4)])
def test_qsgd_unpack_grouped_row_major_matches_single_bucket(held, p_data,
                                                             bits):
    """The per-rank executor's segments: codes as its allgather receives
    them, (held ranks, rows, p_data, shard), p_pod 1, mean 1. Each output
    row is the single-bucket plain unpack of the codes in order, bit for
    bit but for the sign of a zero: the pod sum starts at +0, as the
    kernel's does, so a -0 (a negative code times a zero scale) comes out
    +0."""
    rng = np.random.default_rng(50 * held + p_data + bits)
    segs = []
    for rows, shard, bq in ((3, 128, 128), (2, 256, 128), (1, 128, 64)):
        s = _segment(rng, 1, p_data, held * rows, shard, bq, bits, 1.0)
        segs.append(s._replace(row_major=True))
    outs = unpack_ops.qsgd_unpack_grouped(segs, bits)
    for seg, out in zip(segs, outs):
        want = unpack_ops.qsgd_unpack(seg.packed, seg.scale, bits)
        assert out.shape == (seg.rows, p_data * seg.shard)
        assert out.view(torch.int32).equal(
            (want.reshape(out.shape) + 0.0).view(torch.int32))


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_qsgd_unpack_grouped_refuses_shard_not_multiple_of_bq(impl):
    rng = np.random.default_rng(5)
    seg = _segment(rng, 1, 2, 3, 128, 128, 4, 1.0)
    bad = seg._replace(shard=192, packed=seg.packed[:, :12].contiguous())
    before = unpack_ops.qsgd_unpack_grouped.launches
    with pytest.raises(ValueError, match="multiple of bq"):
        unpack_ops.qsgd_unpack_grouped([seg, bad], 4, impl=impl)
    assert unpack_ops.qsgd_unpack_grouped.launches == before


# --------------------------------------------------------------------------
# dispatch by device
# --------------------------------------------------------------------------

def _calls():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    rand = torch.from_numpy(_u32(rng, (4, 128)))
    lidx = torch.zeros((4, 2), dtype=torch.int32)
    val = torch.ones((4, 2))
    packed = torch.zeros((4, 16), dtype=torch.uint32)
    scale = torch.ones((4, 1))
    seg = UnpackSegment(packed, scale, 1, 2, 2, 128, 128, 0.5)
    sseg = ScatterSumSegment(lidx.view(1, 2, 2, 2), val.view(1, 2, 2, 2), 128)
    pseg = PackSegment(x, rand, 1, 2, 2, 128, 128)
    return [
        (topk_ops.bucket_topk, lambda impl: topk_ops.bucket_topk(x, 2, impl=impl)),
        (scatter_ops.bucket_scatter,
         lambda impl: scatter_ops.bucket_scatter(lidx, val, 128, impl=impl)),
        (pack_ops.qsgd_pack,
         lambda impl: pack_ops.qsgd_pack(x, rand, 4, impl=impl)),
        (unpack_ops.qsgd_unpack,
         lambda impl: unpack_ops.qsgd_unpack(packed, scale, 4, impl=impl)),
        (unpack_ops.qsgd_unpack_grouped,
         lambda impl: unpack_ops.qsgd_unpack_grouped([seg], 4, impl=impl)),
        (scatter_ops.bucket_scatter_sum,
         lambda impl: scatter_ops.bucket_scatter_sum(*sseg, impl=impl)),
        (scatter_ops.bucket_scatter_sum,
         lambda impl: scatter_ops.bucket_scatter_sum_grouped([sseg],
                                                             impl=impl)),
        (pack_ops.qsgd_pack,
         lambda impl: pack_ops.qsgd_pack_grouped([pseg], 4, impl=impl)),
    ]


@pytest.mark.parametrize("which", range(8))
def test_cpu_tensor_takes_plain_version_without_a_launch(which):
    wrapper, call = _calls()[which]
    before = wrapper.launches
    call("auto")
    call("ref")
    assert wrapper.launches == before


@pytest.mark.parametrize("which", range(8))
def test_cuda_impl_on_cpu_tensor_raises(which):
    wrapper, call = _calls()[which]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        call("cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        call("triton")
    assert wrapper.launches == before
