"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test skips without CUDA. The file imports no JAX, so it runs on a
machine with a GPU and without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: bit-equal, except bucket_scatter with duplicate indices
(allclose, atol=1e-6: the adds of one row run in j order in both, but
the plain version adds through scatter_add_) and qsgd_pack in 'l2' mode
(a code may move one level, in at most 1e-4 of the codes, where sigma's
sum of squares ran in another order). bucket_scatter_sum is bit-equal
with duplicates too: it sums a source's duplicates first, as the plain
version's scatter does. The grouped unpack sums two pods, and a two-term
sum has one rounding in any order, so it is bit-equal too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bucket_scatter import ops as scatter_ops
from repro_torch.kernels.bucket_topk import ops as topk_ops
from repro_torch.kernels.bucket_topk.cases import adversarial_rows
from repro_torch.kernels.bucket_scatter.ref import ScatterSumSegment
from repro_torch.kernels.qsgd_pack import ops as pack_ops
from repro_torch.kernels.qsgd_pack.ref import PackSegment, u32_to_i64
from repro_torch.kernels.qsgd_unpack import ops as unpack_ops
from repro_torch.kernels.qsgd_unpack.kernel import launch_grouped
from repro_torch.kernels.qsgd_unpack.ref import UnpackSegment


def _x_with_ties(seed, nb, b):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, b)).astype(np.float32)
    x[0] = 1.0
    x[1, 1::2] = -x[1, ::2]
    x[2] = np.round(x[2])
    x[3] = 0.0
    return x


def _distinct_lidx(rng, nb, b, k):
    return np.sort(np.stack([rng.choice(b, size=k, replace=False)
                             for _ in range(nb)]), axis=1).astype(np.int32)


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [
    (b, k) for b in (128, 256, 384, 512, 640, 1024, 2048, 4096, 8192)
    for k in sorted({1, 4, 8, 16, 64, max(1, b // 64), b // 2, b})])
def test_cuda_bucket_topk_matches_plain(cuda_device, b, k):
    """Bit for bit on val, lidx and res (signed zeros included): rows with
    ties and an all-zero row, then every adversarial row set."""
    rows = [torch.from_numpy(_x_with_ties(b + k, 300, b))]
    rows += list(adversarial_rows(16, b, seed=k).values())
    x = torch.cat(rows).to(cuda_device)
    got = topk_ops.bucket_topk(x, k, impl="cuda")
    want = topk_ops.bucket_topk(x, k, impl="ref")
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_cuda_bucket_scatter_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    lidx = torch.from_numpy(_distinct_lidx(rng, 999, 512, 8)).to(cuda_device)
    val = torch.from_numpy(
        rng.standard_normal((999, 8)).astype(np.float32)).to(cuda_device)
    assert torch.equal(scatter_ops.bucket_scatter(lidx, val, 512, impl="cuda"),
                       scatter_ops.bucket_scatter(lidx, val, 512, impl="ref"))
    dup = torch.randint(-2, 40, (999, 8), dtype=torch.int32, device=cuda_device)
    dup[dup >= 32] = 512
    torch.testing.assert_close(
        scatter_ops.bucket_scatter(dup, val, 512, impl="cuda"),
        scatter_ops.bucket_scatter(dup, val, 512, impl="ref"),
        rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_qsgd_matches_plain(cuda_device, bits):
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.standard_normal((333, 1024)).astype(np.float32))
    x[7] = 0.0
    rand = torch.from_numpy(_u32(rng, (333, 1024)))
    x, rand = x.to(cuda_device), rand.to(cuda_device)
    p, s = pack_ops.qsgd_pack(x, rand, bits, "max", impl="cuda")
    pr, sr = pack_ops.qsgd_pack(x, rand, bits, "max", impl="ref")
    assert torch.equal(s, sr)
    assert torch.equal(p.view(torch.int32), pr.view(torch.int32))
    assert torch.equal(unpack_ops.qsgd_unpack(p, s, bits, impl="cuda"),
                       unpack_ops.qsgd_unpack(p, s, bits, impl="ref"))


@pytest.mark.cuda
def test_cuda_qsgd_pack_refuses_unaligned_rows(cuda_device):
    """A contiguous view that starts off a 16-byte boundary would fault in
    the kernel's float4 loads; the launcher raises instead."""
    flat = torch.randn(4 * 128 + 1, device=cuda_device)
    x = flat[1:].view(4, 128)
    rand = torch.zeros((4, 128), dtype=torch.uint32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        pack_ops.qsgd_pack(x, rand, 4, "max", impl="cuda")


def _grouped_segments(rng, nseg, bits, device, p_pod=2, mean=1.0 / 3.0):
    """Segments of mixed geometry: QSGD rows of 48 to 1200 entries (whole
    16-byte groups of words or not, one to three tiles of 128 words), one
    to three ranks and QSGD rows a rank, and an empty bucket."""
    segs = []
    for i in range(nseg):
        bq = int(rng.choice([48, 128, 1024, 1200]))
        p_data, nbq = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        rows = 0 if i == 1 else int(rng.integers(1, 6))
        nq = p_pod * p_data * rows * nbq
        packed = torch.from_numpy(_u32(rng, (nq, bq * bits // 32)))
        scale = torch.from_numpy(
            np.abs(rng.standard_normal((nq, 1))).astype(np.float32))
        scale[::5] = 0.0
        segs.append(UnpackSegment(packed.to(device), scale.to(device), p_pod,
                                  p_data, rows, nbq * bq, bq, mean))
    return segs


@pytest.mark.cuda
@pytest.mark.parametrize("nseg", [30, 101])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_qsgd_unpack_grouped_matches_plain(cuda_device, bits, nseg):
    """Segment 1 is empty: 30 segments take one launch, 101 take three
    (48 + 48 + 4 non-empty ones)."""
    segs = _grouped_segments(np.random.default_rng(nseg + bits), nseg, bits,
                             cuda_device)
    before = unpack_ops.qsgd_unpack_grouped.launches
    got = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="cuda")
    assert unpack_ops.qsgd_unpack_grouped.launches == before + (
        3 if nseg == 101 else 1)
    torch.cuda.synchronize()
    want = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="ref")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_qsgd_unpack_grouped_refuses_unaligned_buffers(cuda_device):
    """A view that starts off a 16-byte boundary would fault in the kernel's
    float4 stores or uint4 loads; the launcher raises instead."""
    seg = _grouped_segments(np.random.default_rng(0), 1, 4, cuda_device)[0]
    size = seg.rows * seg.p_data * seg.shard
    flat = torch.empty(size + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        launch_grouped([seg], flat[1:], 4)
    words = torch.empty(seg.packed.numel() + 1, dtype=torch.uint32,
                        device=cuda_device)
    shifted = seg._replace(packed=words[1:].view(seg.packed.shape))
    with pytest.raises(ValueError, match="16-byte"):
        launch_grouped([shifted], flat[:size], 4)


@pytest.mark.cuda
def test_cuda_pipelined_driver_matches_sequential_steps(cuda_device):
    """A 2-layer model, 6 staleness-1 steps through the async driver
    (supersteps of 2, two deep, the reduce half on the side stream) equal
    the same step called one at a time with a device synchronisation
    after each, bit for bit: no tensor is reused across streams early."""
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.driver import DriverConfig, run_pipelined
    from repro_torch.runtime.pipeline import attach_inflight, build_superstep
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.train_step import init_state
    from repro_torch.utils.tree import tree_leaves

    model = build_model(ModelConfig(
        name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=1024, vocab_size=512, dtype=torch.float32,
        param_dtype=torch.float32, max_seq_len=64))
    tcfg = TrainConfig(
        sync=SyncConfig(mode="sparcml", k_per_bucket=8, bucket_size=512,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        min_sparse_size=65536),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=2,
                                total_steps=10),
        microbatches=2)
    data = DataConfig(global_batch=8, seq_len=32, vocab_size=512)
    batch = lambda step: synthetic_batch(data, step)
    sup, plan = build_superstep(model, tcfg, 4, cuda_device, steps=2,
                                guard=True)
    assert plan.num_sparse_buckets > 0
    fresh = lambda: attach_inflight(init_state(model, tcfg, plan,
                                               cuda_device), plan)
    state, log = run_pipelined(sup, fresh(), start_step=0, num_steps=6,
                               batch_fn=batch,
                               cfg=DriverConfig(depth=2, steps_per_unit=2))
    torch.cuda.synchronize()
    ref, losses = fresh(), []
    for i in range(6):
        ref, m = sup.step(ref, batch(i))
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
    assert log.losses == losses
    for f in ("params", "opt", "residuals", "inflight"):
        for a, b in zip(tree_leaves(getattr(state, f)),
                        tree_leaves(getattr(ref, f))):
            assert torch.equal(a, b)


ALGORITHMS = ("ssar_recursive_double", "ssar_split_allgather",
              "dsar_split_allgather", "ssar_balanced_split",
              "ssar_rearranged_rs", "dense")


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_cuda_make_sparse_allreduce_matches_exact_sum(cuda_device, algo):
    """Every algorithm over StackedCollectives(8) on the card, at a small
    N with fully overlapping supports (no capacity binds), against the
    exact sum of the 8 ranks' TopK streams in f64; the kernels' launch
    counts show the path went through them, and a second call gives the
    same bits."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core.allreduce import make_sparse_allreduce
    from repro_torch.core.topk import compress

    n, k, b = 1 << 15, 8, 512
    rng = np.random.default_rng(len(algo))
    x = rng.standard_normal((8, n)).astype(np.float32) * 0.01
    hot = (np.arange(n // b)[:, None] * b + np.arange(k)).reshape(-1)
    big = 1 + np.abs(rng.standard_normal((8, hot.size)))   # always selected
    x[:, hot] += (np.sign(rng.standard_normal((8, hot.size))) * big).astype(
        np.float32)
    x = torch.from_numpy(x).to(cuda_device)
    f = make_sparse_allreduce(StackedCollectives(8, cuda_device), n, k, b,
                              algorithm=algo)
    topk_ops.bucket_topk.launches = 0
    out = f(x)
    assert topk_ops.bucket_topk.launches == 1
    exact = compress(x, k, b, impl="ref")[0].densify(impl="ref").double().sum(0)
    tol = 1e-6 * float(exact.abs().max())
    for r in range(8):
        torch.testing.assert_close(out[r].double(), exact, rtol=1e-5, atol=tol)
    assert torch.equal(f(x), out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ssar_balanced_split_inside",
                                  "ssar_rearranged_rs_inside"])
def test_cuda_clamped_algorithms_fold_what_they_clip(cuda_device, name):
    """The two capacity-clamped algorithms on the card on plain normals,
    where their caps bind: the replicated result plus the ranks' folds is
    the exact sum of the 8 ranks' TopK streams (built with the plain
    versions, in f64), at the tolerance of the test above."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core import allreduce as ar
    from repro_torch.core.topk import compress

    n, k, b = 1 << 15, 8, 512
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, n)).astype(np.float32)).to(cuda_device)
    topk_ops.bucket_topk.launches = 0
    u, _ = compress(x, k, b)
    assert topk_ops.bucket_topk.launches == 1
    dense, fold = getattr(ar, name)(u, coll=StackedCollectives(8, cuda_device))
    assert int((fold != 0).sum()) > 0                     # the cap binds
    assert all(torch.equal(dense[r], dense[0]) for r in range(8))
    exact = compress(x, k, b, impl="ref")[0].densify(impl="ref").double().sum(0)
    torch.testing.assert_close(dense[0].double() + fold.double().sum(0), exact,
                               rtol=1e-5, atol=1e-6 * float(exact.abs().max()))


@pytest.mark.cuda
def test_cuda_unsupported_bucket_size_raises_when_built(cuda_device):
    """B = 1000 is no multiple of 128: the step, the pipelined step and
    the allreduce refuse it when built, naming the limit, before any
    launch; the plain version takes it."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core.allreduce import make_sparse_allreduce
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.runtime.pipeline import build_pipelined_step
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.train_step import build_train_step

    model = build_model(ModelConfig(
        name="t", family="dense", num_layers=1, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=1000, vocab_size=1000, dtype=torch.float32,
        param_dtype=torch.float32, max_seq_len=64))
    tcfg = TrainConfig(sync=SyncConfig(mode="sparcml", bucket_size=1000,
                                       algorithm="dsar_split_allgather",
                                       min_sparse_size=1024))
    before = topk_ops.bucket_topk.launches
    limit = "multiple of 128 up to 8192"
    with pytest.raises(ValueError, match=limit):
        build_train_step(model, tcfg, 4, cuda_device)
    with pytest.raises(ValueError, match=limit):
        build_train_step(model, tcfg, 4, cuda_device, lowering="manual")
    with pytest.raises(ValueError, match=limit):
        build_pipelined_step(model, tcfg, 4, cuda_device, lowering="manual")
    with pytest.raises(ValueError, match=limit):
        make_sparse_allreduce(StackedCollectives(4, cuda_device), 8000, 4,
                              1000, algorithm="dsar_split_allgather")
    assert topk_ops.bucket_topk.launches == before
    x = torch.randn(3, 1000, device=cuda_device)
    assert topk_ops.bucket_topk(x, 4, impl="ref")[1].shape == (3, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_qsgd_unpack_grouped_row_major_matches_plain(cuda_device, bits):
    """The per-rank executor's segments (codes as received: rows, ranks,
    shard; p_pod 1, mean 1) through the kernel, bit-equal to the plain
    grouped version."""
    segs = [s._replace(row_major=True, mean=1.0) for s in _grouped_segments(
        np.random.default_rng(7 + bits), 12, bits, cuda_device, p_pod=1)]
    got = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="cuda")
    want = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="ref")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_cuda_manual_pipelined_step_matches_cpu(cuda_device):
    """A 2-layer model, 3 staleness-1 per-rank steps (4 stacked ranks,
    telemetry on) on the card against the CPU path with the same QSGD
    bits: losses within rtol 2e-4; one grouped unpack a step and no
    single-bucket one; the telemetry rows finite and their coverage in
    (0, 1]."""
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.core.qsgd import random_bits
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.pipeline import (attach_inflight,
                                              build_pipelined_step)
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.train_step import init_state
    from repro_torch.utils.tree import tree_map

    model = build_model(ModelConfig(
        name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=1024, vocab_size=512, dtype=torch.float32,
        param_dtype=torch.float32, max_seq_len=64))
    tcfg = TrainConfig(
        sync=SyncConfig(mode="sparcml", k_per_bucket=8, bucket_size=512,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        min_sparse_size=65536),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=2,
                                total_steps=10),
        microbatches=2)
    data = DataConfig(global_batch=8, seq_len=32, vocab_size=512)
    params = model.init(torch.Generator().manual_seed(3), "cpu")

    def bits_for(step, device):
        def rand_fn(bucket_idx, n):
            g = torch.Generator().manual_seed(step * 1000 + bucket_idx)
            return random_bits(n, g, "cpu").to(device)
        return rand_fn

    losses = {}
    for dev in ("cpu", cuda_device):
        step, plan = build_pipelined_step(model, tcfg, 4, dev, guard=True,
                                          lowering="manual")
        state = attach_inflight(init_state(
            model, tcfg, plan, dev,
            params=tree_map(lambda t: t.to(dev), params)), plan)
        unpack_ops.qsgd_unpack.launches = 0
        unpack_ops.qsgd_unpack_grouped.launches = 0
        losses[str(dev)] = []
        for i in range(3):
            state, m = step(state, synthetic_batch(data, i), bits_for(i, dev))
            losses[str(dev)].append(float(m["loss"]))
            for row in m["telemetry"].values():
                assert torch.isfinite(row).all()
                assert 0 < float(row[2]) <= 1
        if dev != "cpu":
            assert unpack_ops.qsgd_unpack_grouped.launches == 3
            assert unpack_ops.qsgd_unpack.launches == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-4)


def _scatter_sum_segments(rng, device, dups):
    """Segments of mixed geometry: G from 1 to 4, S from 1 to 5, k of 1 to
    1000 (a flat k that leaves lanes idle, one to four 32-entry chunks, a
    source of exactly three, and sources longer than the four chunks whose
    loads are in flight at once, k = B included), B from 8 to 4096 (the
    larger two past 48 KB of shared memory a block), an empty one; with
    ``dups``, duplicate, sentinel and negative indices."""
    geo = [(2, 4, 37, 8, 512), (1, 1, 0, 4, 128), (3, 2, 5, 40, 2048),
           (1, 4, 9, 100, 256), (4, 3, 11, 1, 8), (1, 2, 3, 64, 4096),
           (1, 3, 5, 160, 512), (2, 2, 4, 512, 512), (1, 2, 3, 1000, 2048),
           (2, 3, 4, 96, 512), (1, 5, 6, 12, 256)]
    segs = []
    for g, s, nb, k, b in geo:
        shape = (g, s, nb, k)
        if dups:
            lidx = rng.integers(-2, max(2, min(b, k) // 2) + 3, size=shape)
            lidx[rng.random(shape) < 0.1] = b + 3
        else:
            lidx = np.sort(rng.random(shape[:3] + (b,)).argsort(-1)[..., :k], -1)
        val = rng.standard_normal(shape).astype(np.float32)
        segs.append(ScatterSumSegment(
            torch.from_numpy(lidx.astype(np.int32)).to(device),
            torch.from_numpy(val).to(device), b))
    return segs


@pytest.mark.cuda
@pytest.mark.parametrize("dups", [False, True])
def test_cuda_bucket_scatter_sum_matches_plain(cuda_device, dups):
    """The grouped launch and each one-segment call bit-equal to the plain
    version (each source densified, then summed in source order), with
    distinct indices and with duplicates, sentinels and negative indices;
    one launch for the group, one for each non-empty segment alone; the
    single-source densify of one source of each segment with k > 128
    bit-equal too."""
    segs = _scatter_sum_segments(np.random.default_rng(int(dups)),
                                 cuda_device, dups)
    before = scatter_ops.bucket_scatter_sum.launches
    got = scatter_ops.bucket_scatter_sum_grouped(segs, impl="cuda")
    assert scatter_ops.bucket_scatter_sum.launches == before + 1
    for seg, g in zip(segs, got):
        want = scatter_ops.bucket_scatter_sum(*seg, impl="ref")
        assert g.shape == want.shape == (seg.lidx.shape[0],
                                         seg.lidx.shape[2], seg.b)
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))
        one = scatter_ops.bucket_scatter_sum(*seg, impl="cuda")
        assert torch.equal(one.view(torch.int32), want.view(torch.int32))
    assert scatter_ops.bucket_scatter_sum.launches == before + 1 + sum(
        seg.lidx.shape[2] > 0 for seg in segs)
    long = [seg for seg in segs if seg.lidx.shape[3] > 128]
    n_before = scatter_ops.bucket_scatter.launches
    for seg in long:
        li, va = seg.lidx[-1, -1], seg.val[-1, -1]
        one = scatter_ops.bucket_scatter(li, va, seg.b, impl="cuda")
        want = scatter_ops.bucket_scatter(li, va, seg.b, impl="ref")
        assert torch.equal(one.view(torch.int32), want.view(torch.int32))
    assert len(long) == 3
    assert scatter_ops.bucket_scatter.launches == n_before + len(long)


@pytest.mark.cuda
def test_cuda_bucket_scatter_sum_refuses_bad_segments(cuda_device):
    """Shapes that disagree, a 3-D stream, a B that is no multiple of 4 or
    over 8192, other dtypes and strided views raise before any launch."""
    lidx = torch.zeros((1, 2, 3, 4), dtype=torch.int32, device=cuda_device)
    val = torch.ones((1, 2, 3, 4), device=cuda_device)
    bad = [(lidx, val[..., :3].contiguous(), 8), (lidx[0], val[0], 8),
           (lidx, val, 6), (lidx, val, 8196), (lidx.long(), val, 8),
           (lidx, val.double(), 8), (lidx.transpose(1, 2), val, 8)]
    before = scatter_ops.bucket_scatter_sum.launches
    for li, va, b in bad:
        with pytest.raises(ValueError):
            scatter_ops.bucket_scatter_sum_grouped(
                [ScatterSumSegment(lidx, val, 8), ScatterSumSegment(li, va, b)],
                impl="cuda")
    assert scatter_ops.bucket_scatter_sum.launches == before


def _pack_segments(rng, device, bits):
    """Segments of mixed geometry: the stacked executor's strided layout and
    ones whose rows lie in order (p_data 1 or one row), p_pod 1 or 2, p_data 1 to 4, QSGD rows of 64 to 2048
    entries (2048: two register tiles), an empty one; zero rows (code s)
    and tiny ones."""
    geo = [(1, 4, 3, 2, 1024), (2, 2, 2, 3, 64), (1, 1, 0, 1, 128),
           (2, 3, 2, 1, 2048), (1, 1, 7, 2, 256),
           (1, 4, 1, 1, 96 if bits != 2 else 128)]
    segs = []
    for p_pod, p_data, rows, nbq, bq in geo:
        shard = nbq * bq
        n = p_pod * rows * p_data * shard
        x = rng.standard_normal(n).astype(np.float32)
        if n:
            x[:bq] = 0.0
            x[-bq:] *= 1e-30
        rand = _u32(rng, (n,))
        segs.append(PackSegment(
            torch.from_numpy(x).to(device).view(p_pod, rows, p_data * shard),
            torch.from_numpy(rand).to(device), p_pod, p_data, rows, shard, bq))
    return segs


def _codes_of(packed, bits):
    shifts = torch.arange(32 // bits, device=packed.device) * bits
    return (u32_to_i64(packed)[..., None] >> shifts) & (2**bits - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["max", "l2"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_qsgd_pack_grouped_matches_plain(cuda_device, bits, mode):
    """The grouped launch (the summed buffer read in place, strided or
    with its rows in order) and each one-segment call against the plain version: 'max'
    bit-equal, 'l2' codes at most one level apart on at most 1e-4 of them
    and scales within rtol 1e-6; the codes go straight into the grouped
    unpack."""
    segs = _pack_segments(np.random.default_rng(bits), cuda_device, bits)
    before = pack_ops.qsgd_pack.launches
    got = pack_ops.qsgd_pack_grouped(segs, bits, mode, impl="cuda")
    assert pack_ops.qsgd_pack.launches == before + 1
    want = pack_ops.qsgd_pack_grouped(segs, bits, mode, impl="ref")
    moved, total = 0, 0
    for seg, (p, sc), (pr, scr) in zip(segs, got, want):
        assert p.shape == pr.shape and sc.shape == scr.shape
        assert p.data_ptr() % 16 == 0
        if mode == "max":
            assert torch.equal(sc, scr)
            assert torch.equal(p.view(torch.int32), pr.view(torch.int32))
        else:
            torch.testing.assert_close(sc, scr, rtol=1e-6, atol=0)
            dc = (_codes_of(p, bits) - _codes_of(pr, bits)).abs()
            assert dc.numel() == 0 or int(dc.max()) <= 1
            moved += int((dc > 0).sum())
            total += dc.numel()
    assert moved <= max(1, int(1e-4 * total))
    if mode == "max":
        useg = [UnpackSegment(p, sc, *seg[2:7], 0.5)
                for seg, (p, sc) in zip(segs, got)]
        for g, w in zip(unpack_ops.qsgd_unpack_grouped(useg, bits, impl="cuda"),
                        unpack_ops.qsgd_unpack_grouped(useg, bits, impl="ref")):
            assert torch.equal(g, w)
    n_before = pack_ops.qsgd_pack.launches
    for seg in segs:
        in_order = seg.p_data == 1 or seg.rows == 1   # q*bq is row q
        rows = seg.x.reshape(-1, seg.bq) if in_order else None
        if rows is not None and rows.shape[0]:
            one = pack_ops.qsgd_pack(rows, seg.rand.view(-1, seg.bq), bits,
                                     "max", impl="cuda")
            ref = pack_ops.qsgd_pack(rows, seg.rand.view(-1, seg.bq), bits,
                                     "max", impl="ref")
            assert torch.equal(one[1], ref[1])
            assert torch.equal(one[0].view(torch.int32),
                               ref[0].view(torch.int32))
    assert pack_ops.qsgd_pack.launches == n_before + 2


@pytest.mark.cuda
def test_cuda_qsgd_pack_grouped_refuses_bad_segments(cuda_device):
    """x or rand off a 16-byte boundary, sizes that disagree with the
    geometry, a shard that is no multiple of bq, other dtypes: the launcher
    raises before any launch."""
    seg = _pack_segments(np.random.default_rng(0), cuda_device, 4)[0]
    flat = torch.empty(seg.x.numel() + 1, device=cuda_device)
    words = torch.empty(seg.rand.numel() + 1, dtype=torch.uint32,
                        device=cuda_device)
    bad = [(seg._replace(x=flat[1:]), "16-byte"),
           (seg._replace(rand=words[1:]), "16-byte"),
           (seg._replace(rows=seg.rows + 1), "entries"),
           (seg._replace(bq=768), "multiple"),
           (seg._replace(x=seg.x.double()), "float32"),
           (seg._replace(rand=seg.rand.view(torch.int32)), "uint32")]
    before = pack_ops.qsgd_pack.launches
    for b, match in bad:
        with pytest.raises(ValueError, match=match):
            pack_ops.qsgd_pack_grouped([seg, b], 4, "l2", impl="cuda")
    assert pack_ops.qsgd_pack.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(1, 4), (2, 2)])
def test_cuda_stacked_reduce_half_one_launch_each(cuda_device, grid):
    """The stacked reduce half of a 2-layer model (DSAR + 4-bit QSGD,
    'max' scales) on the card makes exactly one launch each of
    bucket_scatter_sum, qsgd_pack and qsgd_unpack (besides one grouped
    bucket_topk a fusion group, and no single-source densify), and its
    reduced buffers and residuals equal the CPU path's bit for bit on the
    same gradients and rounding bits."""
    from repro_torch.comm.executor import (reduce_buckets_spmd,
                                           topk_launches_spmd)
    from repro_torch.comm.plan import build_sync_plan
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.core.qsgd import random_bits
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.specs import param_specs
    from repro_torch.utils.tree import tree_flatten

    p_pod, p_data = grid
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=1024, vocab_size=512,
                      dtype=torch.float32, param_dtype=torch.float32,
                      max_seq_len=64)
    shapes = init_params(cfg, device="meta")
    plan = build_sync_plan(shapes, param_specs(shapes, cfg), SyncConfig(
        mode="sparcml", k_per_bucket=8, bucket_size=512,
        algorithm="dsar_split_allgather", qsgd_bits=4, qsgd_bucket=512,
        qsgd_scale="max", min_sparse_size=65536), 4)
    n_sparse = plan.num_sparse_buckets
    assert n_sparse > 1
    n_groups = sum(any(b.has_residual for b in g.buckets)
                   for g in plan.groups)
    assert topk_launches_spmd(plan, p_data, p_pod) == n_groups <= n_sparse
    rng = np.random.default_rng(11)
    grads = [torch.from_numpy(rng.standard_normal((4,) + tuple(l.shape))
                              .astype(np.float32))
             for l in tree_flatten(shapes)[0]]
    res = {nm: torch.from_numpy(rng.standard_normal(tuple(r.shape))
                                .astype(np.float32) * 1e-3)
           for nm, r in plan.init_residuals().items()}

    def bits_on(device):
        def rand_fn(bucket_idx, n):
            g = torch.Generator().manual_seed(bucket_idx)
            return random_bits(n, g, "cpu").to(device)
        return rand_fn

    want = reduce_buckets_spmd(plan, grads, res, p_data=p_data, p_pod=p_pod,
                               rand_fn=bits_on("cpu"), telemetry=False)
    grads = [g.to(cuda_device) for g in grads]
    res = {nm: r.to(cuda_device) for nm, r in res.items()}
    counters = (topk_ops.bucket_topk, scatter_ops.bucket_scatter,
                scatter_ops.bucket_scatter_sum, pack_ops.qsgd_pack,
                unpack_ops.qsgd_unpack_grouped)
    before = [c.launches for c in counters]
    grouped = topk_ops.bucket_topk.grouped_buckets
    got = reduce_buckets_spmd(plan, grads, res, p_data=p_data, p_pod=p_pod,
                              rand_fn=bits_on(cuda_device), telemetry=False)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        n_groups, 0, 1, 1, 1]
    assert topk_ops.bucket_topk.grouped_buckets - grouped == n_sparse
    for part in (0, 1):
        assert list(got[part]) == list(want[part])
        for nm in want[part]:
            assert torch.equal(got[part][nm].cpu(), want[part][nm]), nm


def _ef_groups(rng, lead, b):
    """Two packed group buffers of (lead, rows, cols) gradients with their
    EF buckets' spans: rows 1 with buckets of 1, 2 and 3 rows of B (a gap
    between them), and rows 3 with 49 buckets of B (one more than a launch
    takes: strided slices, two launches). Gaussian rows, and rows of
    ties, signed zeros, infinities and denormals (the adversarial rows)."""
    from repro_torch.kernels.bucket_topk.cases import adversarial_rows

    groups = []
    for rows, spans in ((1, [(0, b), (2 * b, 2 * b), (4 * b, 3 * b)]),
                        (3, [(i * b, b) for i in range(49)])):
        cols = spans[-1][0] + spans[-1][1]
        buf = torch.from_numpy(rng.standard_normal(
            (lead, rows, cols)).astype(np.float32))
        flat = buf.view(-1, b)
        adv = torch.cat(list(adversarial_rows(2, b, seed=rows).values()))
        flat[1:1 + len(adv)] = adv[:flat.shape[0] - 1]
        groups.append((buf, spans))
    return groups


@pytest.mark.cuda
@pytest.mark.parametrize("b", [128, 512, 1024, 8192])
@pytest.mark.parametrize("k", [1, 4, 64])
def test_cuda_bucket_topk_ef_grouped_matches_per_bucket(cuda_device, b, k):
    """The grouped, fused EF add + TopK is bit for bit bucket_topk(res +
    seg) bucket by bucket (the add on the card as the executor made it,
    then the one-tensor kernel) and the plain version: val, lidx (in the
    flat stream buffers at the table's offsets) and the new residuals, on
    rows of one group buffer and strided slices of a rows-3 one, with
    residuals that cancel whole rows to signed zeros; the launches rise by
    the library's count and grouped_buckets by the buckets."""
    from repro_torch.kernels.bucket_topk.kernel import (MAX_EF_SEGS,
                                                        EfTopkTable)

    rng = np.random.default_rng(b + k)
    lead = 2
    stream = 0
    tables, calls = [], []
    for buf, spans in _ef_groups(rng, lead, b):
        t = EfTopkTable(lead, buf.shape[1], buf.shape[2], spans, b, k,
                        stream_start=stream)
        stream = t.stream_end
        res = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in t.res_shapes]
        res[0][0, 0, :b] = -buf[0, 0, :b]           # r + g = +0 a row
        res[-1].zero_()
        tables.append(t)
        calls.append((buf, res))
    val = torch.full((stream,), float("nan"), device=cuda_device)
    lidx = torch.full((stream,), -1, dtype=torch.int32, device=cuda_device)
    before = topk_ops.bucket_topk.launches
    grouped = topk_ops.bucket_topk.grouped_buckets
    outs = [topk_ops.bucket_topk_ef_grouped(
        t, [r.to(cuda_device) for r in res], buf.to(cuda_device), val, lidx,
        impl="cuda") for t, (buf, res) in zip(tables, calls)]
    torch.cuda.synchronize()
    assert topk_ops.bucket_topk.launches - before == sum(
        -(-t.n // MAX_EF_SEGS) for t in tables) == 3
    assert topk_ops.bucket_topk.grouped_buckets - grouped == 52

    def same(a, c):
        return torch.equal(a.cpu().view(torch.int32),
                           c.cpu().view(torch.int32))

    for t, (buf, res), out in zip(tables, calls, outs):
        for i, (cs, cols) in enumerate(t.spans):
            acc = res[i].to(cuda_device) + buf.to(cuda_device)[:, :,
                                                               cs:cs + cols]
            want = topk_ops.bucket_topk(acc.reshape(-1, b), k, impl="cuda")
            plain = topk_ops.bucket_topk(acc.cpu().reshape(-1, b), k,
                                         impl="ref")
            o, n = t.stream_off[i], t.stream_sizes[i]
            got = (val[o:o + n].view(-1, k), lidx[o:o + n].view(-1, k),
                   out[i].reshape(-1, b))
            for g, w, p in zip(got, want, plain):
                assert same(g, w) and same(g, p), (b, k, i)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,mode", [((1, 4), "replicated"),
                                       ((2, 2), "replicated"),
                                       ((1, 4), "scattered")])
def test_cuda_stacked_reduce_half_moe_equals_per_bucket_path(
        cuda_device, grid, mode):
    """On the MoE smoke model's plan at one layer (4 groups, rows 1 to
    512; one bucket raw-dense, two EF buckets demoted to the densified
    stream), two error-feedback steps of the stacked reduce half (a
    grouped EF add + TopK a group, the plan-built tables) give, bit for
    bit, the reduced buffers and residuals of the per-rank form, whose
    bucket loop runs the EF add and one bucket_topk a bucket (the stacked
    form's path before the grouped call), on the card; and those of the
    CPU's stacked path ('max' scales: an 'l2' scale's sum of squares runs
    in another order on the card)."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.comm.executor import (reduce_buckets,
                                           reduce_buckets_spmd,
                                           topk_launches_spmd)
    from repro_torch.comm.plan import build_sync_plan
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.core.qsgd import random_bits
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.specs import param_specs
    from repro_torch.utils.tree import tree_flatten

    p_pod, p_data = grid
    R = p_pod * p_data
    cfg = ModelConfig(name="moonshot", family="moe", num_layers=1,
                      d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                      d_ff=32, vocab_size=512, num_experts=8,
                      experts_per_token=2, moe_d_ff=32, moe_shared_ff=64,
                      max_seq_len=128, dtype=torch.float32,
                      param_dtype=torch.float32)
    shapes = init_params(cfg, device="meta")
    plan = build_sync_plan(shapes, param_specs(shapes, cfg), SyncConfig(
        mode="sparcml", k_per_bucket=4, bucket_size=128,
        algorithm="dsar_split_allgather", qsgd_bits=4, qsgd_bucket=128,
        qsgd_scale="max", min_sparse_size=2048, fusion_bucket_bytes=1 << 14,
        output_mode=mode), R).replan(
        algorithms={"g0b1": "dense", "g1b1": "dense"})
    assert [g.rows for g in plan.groups] == [1, 8, 64, 512]
    leaves = tree_flatten(shapes)[0]
    coll = StackedCollectives(p_data, outer=p_pod, device=cuda_device)
    pod_coll = (StackedCollectives(p_pod, inner=p_data, device=cuda_device)
                if p_pod > 1 else None)

    def rand_fn(bucket_idx, n):
        g = torch.Generator().manual_seed(bucket_idx)
        return random_bits(n, g, "cpu").to(cuda_device)

    def cpu_bits(bucket_idx, n):
        return rand_fn(bucket_idx, n).cpu()

    rng = np.random.default_rng(R)
    res_s = res_r = plan.init_residuals(device=cuda_device)
    res_c = plan.init_residuals()
    for _ in range(2):
        grads = [torch.from_numpy(rng.standard_normal(
            (R,) + tuple(l.shape)).astype(np.float32)) for l in leaves]
        card = [g.to(cuda_device) for g in grads]
        before = topk_ops.bucket_topk.launches
        red_s, res_s, _ = reduce_buckets_spmd(
            plan, card, res_s, p_data=p_data, p_pod=p_pod, rand_fn=rand_fn,
            telemetry=False)
        assert topk_ops.bucket_topk.launches - before == \
            topk_launches_spmd(plan, p_data, p_pod) == 4
        red_c, res_c, _ = reduce_buckets_spmd(
            plan, grads, res_c, p_data=p_data, p_pod=p_pod,
            rand_fn=cpu_bits, telemetry=False)
        red_r, res_r, _ = reduce_buckets(
            plan, card, res_r, coll=coll, pod_coll=pod_coll,
            rand_fn=rand_fn, telemetry=False)
        torch.cuda.synchronize()
        for nm, buf in red_s.items():
            assert torch.equal(buf.cpu(), red_c[nm]), nm
            if plan.scattered:
                assert torch.equal(red_r[nm], buf), nm
            else:
                for r in range(R):
                    assert torch.equal(red_r[nm][r], buf), (nm, r)
        for nm in res_s:
            assert torch.equal(res_s[nm], res_r[nm]), nm
            assert torch.equal(res_s[nm].cpu(), res_c[nm]), nm


def _small_lm(device):
    """A 2-layer model with sparse buckets at the main path's sync
    settings (DSAR, 4-bit QSGD, k = 8 of 512), its config and data."""
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.train.state import TrainConfig

    model = build_model(ModelConfig(
        name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=1024, vocab_size=512, dtype=torch.float32,
        param_dtype=torch.float32, max_seq_len=64))
    tcfg = TrainConfig(
        sync=SyncConfig(mode="sparcml", k_per_bucket=8, bucket_size=512,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        min_sparse_size=65536),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=2,
                                total_steps=16),
        microbatches=2)
    return model, tcfg, DataConfig(global_batch=8, seq_len=32,
                                   vocab_size=512)


@pytest.mark.cuda
def test_cuda_obs_on_off_bit_equal_one_wait_a_unit(cuda_device,
                                                    monkeypatch):
    """Observability on (trace, metrics, telemetry rows, health) against
    off on the card: the same losses bit for bit, one host wait a retired
    unit, a valid span tree, and every EF bucket's four histograms with
    one sample a step."""
    from repro_torch import obs
    from repro_torch.runtime import driver as rt_driver
    from repro_torch.train.trainer import Trainer

    model, tcfg, data = _small_lm(cuda_device)
    real = rt_driver._wait
    waits = []
    monkeypatch.setattr(rt_driver, "_wait",
                        lambda done: (waits.append(done is not None),
                                      real(done)))
    runs = {}
    for on in (False, True):
        ob = (obs.configure(trace=True, metrics=True, set_as_default=False)
              if on else None)
        t = Trainer(model, tcfg, data, dp_total=4, device=cuda_device,
                    obs=ob)
        t.init()
        waits.clear()
        runs[on] = list(t.run_pipelined(8, superstep=2).losses)
        assert waits == [True] * 4
    assert runs[True] == runs[False]
    assert obs.validate_span_tree(ob.tracer.events) == []
    ef = [b.name for b in t.plan.buckets if b.has_residual]
    assert ef
    for n in ef:
        for col in ("nnz", "wire_bytes", "mass_coverage", "ef_norm"):
            vals = ob.metrics.histogram(f"bucket/{n}/{col}").values
            assert len(vals) == 8 and np.isfinite(vals).all()


@pytest.mark.cuda
def test_cuda_forced_swap_equals_switching_by_hand(cuda_device):
    """Every EF bucket demoted to dense after step 2, installed at the
    drain barrier of step 4: bit-equal to both plans' steps switched there
    by hand, and after the swap no pack or unpack launches while the fused
    densify + sum stays one a step."""
    from repro_torch.core.cost_model import NetworkParams
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.runtime import adapt as rt_adapt
    from repro_torch.runtime import driver as rt_driver
    from repro_torch.runtime.pipeline import attach_inflight, build_superstep
    from repro_torch.train.train_step import build_plan, init_state

    model, tcfg, data = _small_lm(cuda_device)
    plan = build_plan(model, tcfg, 4)
    ef = [b.name for b in plan.buckets if b.has_residual]
    demoted = plan.replan(algorithms={n: "dense" for n in ef})
    fresh = lambda: attach_inflight(init_state(model, tcfg, plan,
                                               cuda_device), plan)
    batch = lambda i: synthetic_batch(data, i)
    dcfg = rt_driver.DriverConfig(steps_per_unit=2)
    rt = rt_adapt.AdaptiveRuntime(
        model, tcfg, 4, cuda_device, plan=plan,
        net=NetworkParams(alpha=1e-5, link_bytes_per_s=1e10),
        cfg=rt_adapt.AdaptConfig(window=1000), superstep=2, guard=True)
    rt.demote_after(2, ef)
    _, log = rt_driver.run_pipelined(rt.current_fn(), fresh(), start_step=0,
                                     num_steps=8, batch_fn=batch, cfg=dcfg,
                                     adapt=rt)
    assert log.plan_swaps == [(4, demoted.signature())]
    s, losses = fresh(), []
    for p, lo, hi in ((plan, 0, 4), (demoted, 4, 8)):
        fn, _ = build_superstep(model, tcfg, 4, cuda_device, steps=2,
                                guard=True, plan=p)
        for w in (pack_ops.qsgd_pack, unpack_ops.qsgd_unpack_grouped,
                  scatter_ops.bucket_scatter_sum):
            w.launches = 0
        s, hlog = rt_driver.run_pipelined(fn, s, start_step=lo,
                                          num_steps=hi, batch_fn=batch,
                                          cfg=dcfg)
        torch.cuda.synchronize()
        losses += hlog.losses
    assert losses == list(log.losses)
    assert pack_ops.qsgd_pack.launches == 0
    assert unpack_ops.qsgd_unpack_grouped.launches == 0
    assert scatter_ops.bucket_scatter_sum.launches == 4


@pytest.mark.cuda
def test_cuda_readback_drains_only_for_telemetry(cuda_device):
    """The retire's one copy waits for the step's side-stream reduce only
    when telemetry rows (that reduce's results) ride in it."""
    from repro_torch.runtime import driver as rt_driver

    drains = []

    class Step:
        def drain(self):
            drains.append(1)

    side = torch.cuda.Stream(cuda_device)
    loss = torch.arange(2.0, device=cuda_device)
    vals, names, done = rt_driver._readback({"loss": loss}, Step(), side)
    done.synchronize()
    assert names == [] and drains == [] and vals.shape == (1, 2)
    rows = torch.ones(2, 4, device=cuda_device)
    vals, names, done = rt_driver._readback(
        {"loss": loss, "telemetry": {"b": rows}}, Step(), side)
    done.synchronize()
    assert names == ["b"] and drains == [1] and vals.shape == (5, 2)
    assert vals[1:].eq(1).all() and vals[0].tolist() == [0.0, 1.0]


@pytest.mark.cuda
def test_cuda_audit_probe_kernel_refusal_raises(cuda_device, monkeypatch):
    """A probe whose kernel refuses its inputs on the card (bucket_topk
    handed float64) raises out of the drift audit; no probe-failed event
    stands in for it."""
    from repro_torch import obs
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core import allreduce
    from repro_torch.core.cost_model import NetworkParams
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.train.train_step import build_plan

    real = allreduce.make_sparse_allreduce

    def as_f64(*a, **k):
        fn = real(*a, **k)
        return lambda x, rand: fn(x.double(), rand)

    monkeypatch.setattr(allreduce, "make_sparse_allreduce", as_f64)
    model, tcfg, _ = _small_lm(cuda_device)
    plan = build_plan(model, tcfg, 4)
    reg = MetricsRegistry()
    with pytest.raises(ValueError, match="float32"):
        obs.audit_sync_plan(plan, StackedCollectives(4, cuda_device),
                            net=NetworkParams(alpha=1e-5,
                                              link_bytes_per_s=1e10),
                            reps=1, registry=reg)
    assert not reg.events_named("audit/bucket_probe_failed")


@pytest.mark.cuda
def test_cuda_calibrate_and_audit_on_the_stacked_ranks(cuda_device):
    """The ladder on the card (CUDA events) is finite and the card's sizes
    fit the alpha-beta form; the drift audit probes every signature of a
    plan on the card."""
    from repro_torch import obs
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.train.train_step import build_plan
    from repro_torch.utils import calibrate

    coll = StackedCollectives(4, cuda_device)
    meas = calibrate.measure_allreduce_times(coll, sizes=(1 << 16, 1 << 20),
                                             repeats=3)
    assert all(np.isfinite(t) and t > 0 for _, t in meas)
    aud = obs.DriftAuditor()
    net = calibrate.calibrate(coll, auditor=aud)
    assert net.alpha > 0 and net.link_bytes_per_s > 0
    assert len(aud) == len(calibrate.CARD_SIZES)
    model, tcfg, _ = _small_lm(cuda_device)
    plan = build_plan(model, tcfg, 4)
    probes = obs.DriftAuditor()
    obs.audit_sync_plan(plan, coll, net=net, auditor=probes, reps=2)
    assert len(probes) >= 1
    assert all(np.isfinite(s["measured_s"]) and s["measured_s"] > 0
               for s in probes.samples)


# --------------------------------------------------------------------------
# the ZeRO layouts and the chaos harness on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_qsgd_unpack_chunk_layout_matches_plain(cuda_device, bits):
    """The scattered stacked executor's segment (p_pod = p_data = 1, the
    ranks' rows stacked): the launch writes the (p, rows, w) chunks in
    place, bit-equal to the plain version, and each chunk is its rank's
    columns of the replicated layout's buffer."""
    rng = np.random.default_rng(bits)
    p, rows, bq, nbq = 4, 3, 128, 2
    shard = nbq * bq
    nq = p * rows * nbq
    packed = torch.from_numpy(_u32(rng, (nq, bq * bits // 32))).to(
        cuda_device)
    scale = torch.from_numpy(np.abs(rng.standard_normal((nq, 1))).astype(
        np.float32)).to(cuda_device)
    chunk = UnpackSegment(packed, scale, 1, 1, p * rows, shard, bq, 0.25)
    before = unpack_ops.qsgd_unpack_grouped.launches
    (got,) = unpack_ops.qsgd_unpack_grouped([chunk], bits, impl="cuda")
    assert unpack_ops.qsgd_unpack_grouped.launches == before + 1
    (want,) = unpack_ops.qsgd_unpack_grouped([chunk], bits, impl="ref")
    assert got.shape == (p * rows, shard) and torch.equal(got, want)
    (full,) = unpack_ops.qsgd_unpack_grouped(
        [UnpackSegment(packed, scale, 1, p, rows, shard, bq, 0.25)], bits,
        impl="cuda")
    chunks = got.view(p, rows, shard)
    for r in range(p):
        assert torch.equal(chunks[r], full[:, r * shard:(r + 1) * shard])


def _nan_equal(a, b):
    """Equal bits, except that any NaN equals any NaN (a computed NaN's
    payload is the arithmetic's own)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(128, 4), (512, 8), (1024, 16), (8192, 64)])
def test_cuda_kernels_on_nonfinite_rows(cuda_device, b, k):
    """Rows with NaN and Inf, as an injected fault hands the reduce half:
    bucket_topk is bit-equal to its plain version (a NaN's key lies above
    Inf's); bucket_scatter_sum of its streams equals the plain sum (NaN
    for NaN); qsgd_pack raises no error, its codes stay within bits, and
    it equals the plain version where that is defined ('l2' with finite
    scales, or NaN ones, whose rows code as zero in both)."""
    from repro_torch.kernels.bucket_topk.cases import nonfinite_rows

    x = torch.cat(list(nonfinite_rows(16, b, seed=k).values())).to(
        cuda_device)
    got = topk_ops.bucket_topk(x, k, impl="cuda")
    want = topk_ops.bucket_topk(x, k, impl="ref")
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    val, lidx = got[0], got[1]
    assert int(lidx.min()) >= 0 and int(lidx.max()) < b
    s = 4
    seg = ScatterSumSegment(lidx.view(1, s, -1, k), val.view(1, s, -1, k), b)
    assert _nan_equal(scatter_ops.bucket_scatter_sum(*seg, impl="cuda"),
                      scatter_ops.bucket_scatter_sum(*seg, impl="ref"))
    torch.cuda.synchronize()
    bits = 4
    bq = min(b, 1024)
    finite = torch.from_numpy(_x_with_ties(b, 8, bq)).to(cuda_device)
    rows = torch.cat([x.reshape(-1, bq), finite]).contiguous()
    rand = torch.from_numpy(_u32(np.random.default_rng(b), tuple(
        rows.shape))).to(cuda_device)
    for mode in ("l2", "max"):
        p, sc = pack_ops.qsgd_pack(rows, rand, bits, mode, impl="cuda")
        torch.cuda.synchronize()
        codes = (u32_to_i64(p)[..., None] >> (torch.arange(
            32 // bits, device=cuda_device) * bits)) & (2**bits - 1)
        assert int(codes.max()) <= 2 * (2 ** (bits - 1) - 1)
        pr, scr = pack_ops.qsgd_pack(rows, rand, bits, mode, impl="ref")
        if mode == "max":      # bit-equal on finite rows (the plain
            defined = torch.isfinite(rows).all(1)     # version's amax is
        else:                  # NaN on a NaN row, the kernel's fmaxf not)
            # a NaN sum of squares: every code the zero level, in both
            defined = torch.isnan(scr[:, 0])
            assert torch.isnan(sc[defined]).all()
        assert bool(defined.any())
        assert torch.equal(sc[defined].view(torch.int32),
                           scr[defined].view(torch.int32)) or mode == "l2"
        assert torch.equal(p.view(torch.int32)[defined],
                           pr.view(torch.int32)[defined])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["replicated", "scattered"])
def test_cuda_injected_step_has_no_host_sync(cuda_device, mode):
    """The chaos harness's step (a fault vector on the batch, the guarded
    ZeRO step, staleness 1 on the side stream): no host synchronisation
    inside a step (CUDA sync debug mode), an idle vector bit-exact with no
    injector, a NaN vector a no-op on the state."""
    import warnings

    from repro_torch.core.compressor import SyncConfig
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.faults import FAULT_KEY
    from repro_torch.runtime.pipeline import (attach_inflight,
                                              build_pipelined_step)
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.train_step import init_state
    from repro_torch.utils.tree import tree_leaves

    model = build_model(ModelConfig(
        name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=1024, vocab_size=512, dtype=torch.float32,
        param_dtype=torch.float32, max_seq_len=64))
    tcfg = TrainConfig(
        sync=SyncConfig(mode="sparcml", k_per_bucket=8, bucket_size=512,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        min_sparse_size=65536, output_mode=mode),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=2,
                                total_steps=10),
        microbatches=2)
    data = DataConfig(global_batch=8, seq_len=32, vocab_size=512)
    runs = {}
    for inject in (False, True):
        step, plan = build_pipelined_step(model, tcfg, 4, cuda_device,
                                          guard=True, inject=inject)
        state = attach_inflight(init_state(model, tcfg, plan, cuda_device),
                                plan)
        n = len(tree_leaves(state.params))
        syncs = []
        for i in range(4):
            batch = synthetic_batch(data, i)
            if inject:
                batch[FAULT_KEY] = np.zeros(n, np.float32)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, m = step(state, batch)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs += [str(w.message) for w in caught
                      if "called a synchronizing" in str(w.message)]
        assert not syncs, syncs[:3]
        step.drain()
        runs[inject] = (state, step, n)
    (a, _, _), (b, step, n) = runs[False], runs[True]
    for f in ("params", "opt", "residuals", "inflight"):
        for x, y in zip(tree_leaves(getattr(a, f)), tree_leaves(getattr(b, f))):
            assert torch.equal(x, y)
    batch = {**synthetic_batch(data, 4), FAULT_KEY: np.ones(n, np.float32)}
    after, m = step(b, batch)
    step.drain()
    assert float(m["nonfinite"]) == 1.0
    for f in ("params", "opt", "residuals", "inflight"):
        for x, y in zip(tree_leaves(getattr(after, f)),
                        tree_leaves(getattr(b, f))):
            assert torch.equal(x, y)


def _serve_model():
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model

    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype=torch.float32, param_dtype=torch.float32)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def _to(tree, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


@pytest.mark.cuda
def test_cuda_decode_matches_cpu(cuda_device):
    """Prefill and 6 decode steps of a small model on the card against
    the CPU path on the same weights: logits at the model tolerance
    (rtol 1e-5, absolute floor 1e-5 of the largest magnitude)."""
    model, params = _serve_model()
    on_card = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, 14)).astype(np.int32))
    runs = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        lg, st = model.prefill(p, {"tokens": toks[:, :8].to(dev)}, 16)
        out = [lg.cpu()]
        for t in range(8, 14):
            lg, st = model.decode_step(p, st, toks[:, t:t + 1].to(dev))
            out.append(lg.cpu())
        runs[dev] = torch.stack(out)
    want = runs["cpu"].numpy()
    np.testing.assert_allclose(runs["cuda"].numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.cuda
def test_cuda_kv_write_touches_only_its_slot(cuda_device):
    """The per-slot decode writes one cache row a slot in place (at
    min(pos, w - 1)), and an admission copies into its slot's rows only:
    every other row of the stacked caches stays bit-equal."""
    from repro_torch.serve import insert_slot_state

    model, params = _serve_model()
    params = _to(params, cuda_device)
    state = model.init_decode_state(4, 16, device=cuda_device)
    state.kv.k.normal_()
    state.kv.v.normal_()
    pos = torch.tensor([0, 5, 15, 40], dtype=torch.int32, device=cuda_device)
    state = state._replace(pos=pos)
    before = (state.kv.k.clone(), state.kv.v.clone())
    toks = torch.tensor([[1], [2], [3], [4]], dtype=torch.int32,
                        device=cuda_device)
    _, st = model.decode_step(params, state, toks)
    assert st.kv.k.data_ptr() == state.kv.k.data_ptr()
    written = torch.zeros_like(before[0], dtype=torch.bool)
    for b, p in enumerate(pos.tolist()):
        written[:, b, min(p, 15)] = True
    for new, old in zip(st.kv, before):
        assert torch.equal(new[~written], old[~written])
        assert not torch.equal(new[written], old[written])
    before = (st.kv.k.clone(), st.kv.v.clone())
    _, sub = model.prefill(params, {"tokens": toks[:3, 0][None]}, 16)
    insert_slot_state(model.cfg, st, sub, 2)
    assert int(st.pos[2]) == 3
    for new, old, ins in zip(st.kv, before, sub.kv):
        assert torch.equal(new[:, [0, 1, 3]], old[:, [0, 1, 3]])
        assert torch.equal(new[:, 2], ins[:, 0])


# --------------------------------------------------------------------------
# the MoE family on the card
# --------------------------------------------------------------------------

def _moe_smoke():
    from repro_torch import configs
    from repro_torch.models.model import build_model

    model = build_model(configs.smoke_config("moonshot-v1-16b-a3b"))
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.cuda
def test_cuda_moe_apply_reruns_bit_equal_and_match_cpu(cuda_device):
    """The combine is a gather summed in ascending slot order, so two runs
    on the card are bit-equal (an atomic scatter-add would not be); the
    routing ids equal the CPU's, the output is within the model tolerance
    of it."""
    from repro_torch.models import moe

    model, params = _moe_smoke()
    lp = {k: v[0] for k, v in params["blocks"]["moe"].items()
          if torch.is_tensor(v)}
    lp["shared"] = {k: v[0] for k, v in
                    params["blocks"]["moe"]["shared"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, model.cfg.d_model)).astype(np.float32))
    card = _to(lp, cuda_device)
    a = moe.moe_apply(card, model.cfg, x.to(cuda_device))
    b = moe.moe_apply(card, model.cfg, x.to(cuda_device))
    assert torch.equal(a, b)
    want = moe.moe_apply(lp, model.cfg, x).numpy()
    np.testing.assert_allclose(a.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    k = model.cfg.experts_per_token
    assert torch.equal(moe._route(card, x.to(cuda_device), k)[1].cpu(),
                       moe._route(lp, x, k)[1])


@pytest.mark.cuda
def test_cuda_moe_sparcml_steps_match_cpu(cuda_device):
    """Three SparCML steps of the moonshot smoke config (its
    train_config), card against CPU with the same QSGD bits, through the
    kernels on the card (the schedule's lr is 0 at step 0, so two steps
    update the params): losses at the QSGD tolerance (rtol 2e-4), and the
    final params, moments and EF residuals within rtol 2e-4 and 2e-4 of
    each tensor's largest magnitude."""
    from repro_torch import configs
    from repro_torch.comm.executor import topk_launches_spmd
    from repro_torch.core.qsgd import random_bits
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    model, params = _moe_smoke()
    tcfg = configs.get_train_config("moonshot-v1-16b-a3b")

    def bits_for(step, device):
        def rand_fn(bucket_idx, n):
            g = torch.Generator().manual_seed(step * 1000 + bucket_idx)
            return random_bits(n, g, "cpu").to(device)
        return rand_fn

    losses, states = {}, {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(model, tcfg, DataConfig(16, 16, 512), dp_total=4,
                     device=dev)
        tr.init(params=_to(params, dev))
        before = topk_ops.bucket_topk.launches
        losses[str(dev)] = tr.run(3, rand_fn_for_step=lambda s, d=dev:
                                  bits_for(s, d)).losses
        if dev != "cpu":
            assert topk_ops.bucket_topk.launches - before == \
                3 * topk_launches_spmd(tr.plan, 4)
        st = tr.state
        states[str(dev)] = [t.detach().cpu().float().numpy() for t in (
            tree_leaves(st.params) + tree_leaves(st.opt["mu"])
            + tree_leaves(st.opt["nu"])
            + [st.residuals[n] for n in sorted(st.residuals)])]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-4)
    for a, b in zip(states["cuda"], states["cpu"]):
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(b).max()))


@pytest.mark.cuda
def test_cuda_continuous_moe_adaptive_equals_dense(cuda_device):
    """The continuous MoE engine on the card: adaptive dispatch (the
    reference's network parameters) gives the dense engine's tokens, and
    both give each request's B = 1 generate."""
    from repro_torch.core.cost_model import NetworkParams
    from repro_torch.serve import ContinuousServeEngine, Request, ServeEngine
    from repro_torch.models.model import build_model
    from repro_torch.serve.run_serve import serve_demo_config

    model = build_model(serve_demo_config(True))
    params = model.init(torch.Generator().manual_seed(0), device=cuda_device)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, 2048, n),
                    max_new_tokens=m, arrival=a)
            for i, (n, m, a) in enumerate(
                [(4, 6, 0), (6, 5, 0), (3, 6, 0), (5, 4, 0), (7, 5, 0),
                 (4, 5, 0), (5, 22, 0), (6, 20, 1)])]
    # the JAX package's default network (alpha 1 us, 50 GB/s links), which
    # the CPU tests pass too
    net = NetworkParams(alpha=1e-6, link_bytes_per_s=50e9)
    runs = {d: ContinuousServeEngine(
        model, params, cache_len=32, batch_size=8, dispatch=d,
        net=net if d == "adaptive" else None,
        device=cuda_device).run(reqs) for d in ("dense", "adaptive")}
    one = ServeEngine(model, params, cache_len=32, device=cuda_device)
    for r in reqs:
        want = one.generate(r.prompt[None], r.max_new_tokens)[0].tolist()
        assert runs["dense"].outputs[r.rid].tolist() == want
        assert runs["adaptive"].outputs[r.rid].tolist() == want
    assert any(s["reason"] == "telemetry" for s in runs["adaptive"].swap_log)


# --------------------------------------------------------------------------
# the ssm, hybrid, vlm and encoder families on the card
# --------------------------------------------------------------------------

FAMILY_SMOKE = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
                "vlm": "llama-3.2-vision-11b", "encoder": "hubert-xlarge"}


def _family_smoke(fam):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.model import build_model

    model = build_model(configs.smoke_config(FAMILY_SMOKE[fam]))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    if fam == "vlm":       # non-zero gates: the cross layers count
        params["blocks"]["cross"]["xattn"]["gate"].fill_(0.5)
        params["blocks"]["cross"]["mlp_gate"].fill_(-0.7)
    off = build_model(dataclasses.replace(model.cfg, remat=False))
    return model, off, params


def _family_batch(cfg, rng, b, s):
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encoder":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(FAMILY_SMOKE))
def test_cuda_family_logits_and_decode_match_cpu(cuda_device, fam):
    """Each new family's smoke config on the card against the CPU on the
    same weights: forward logits, and (decoders) a prefill of 16 tokens
    and 8 decode steps, at the model tolerance (rtol 1e-5, floor 1e-5 of
    the largest magnitude)."""
    model, _, params = _family_smoke(fam)
    batch = _family_batch(model.cfg, np.random.default_rng(0), 2, 24)
    runs = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda_device))):
        b = {k: v.to(dev) for k, v in batch.items()}
        out = [model(p, b).detach().cpu().reshape(-1)]
        if model.cfg.is_decoder:
            pre = {k: v for k, v in b.items() if k != "labels"}
            pre["tokens"] = b["tokens"][:, :16]
            lg, st = model.prefill(p, pre, 32)
            out.append(lg.cpu().reshape(-1))
            for t in range(16, 24):
                lg, st = model.decode_step(p, st, b["tokens"][:, t:t + 1])
                out.append(lg.cpu().reshape(-1))
        runs[dev] = torch.cat(out).numpy()
    want = runs["cpu"]
    np.testing.assert_allclose(runs["cuda"], want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(FAMILY_SMOKE))
def test_cuda_family_remat_bit_equal(cuda_device, fam):
    """Remat on against off on the card, through rank_grads: the loss and
    every rank's grads bit-equal."""
    from repro_torch.train.train_step import rank_grads

    on, off, params = _family_smoke(fam)
    p = _to(params, cuda_device)
    batch = {k: v.to(cuda_device) for k, v in _family_batch(
        on.cfg, np.random.default_rng(1), 4, 16).items()}
    la, ga = rank_grads(on, p, batch, 2, 2)
    lb, gb = rank_grads(off, p, batch, 2, 2)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


@pytest.mark.cuda
def test_cuda_continuous_ssm_matches_generate(cuda_device):
    """The mamba2 smoke config served continuously on the card: each
    request equals its own B = 1 generate."""
    from repro_torch.serve import ContinuousServeEngine, Request, ServeEngine

    model, _, params = _family_smoke("ssm")
    params = _to(params, cuda_device)
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, n), max_new_tokens=m,
                    arrival=a)
            for i, (n, m, a) in enumerate([(8, 6, 0), (16, 4, 0),
                                           (8, 9, 1), (24, 5, 2),
                                           (8, 7, 4)])]
    res = ContinuousServeEngine(model, params, cache_len=48, batch_size=3,
                                device=cuda_device).run(reqs)
    one = ServeEngine(model, params, cache_len=48, device=cuda_device)
    for r in reqs:
        assert res.outputs[r.rid].tolist() == one.generate(
            r.prompt[None], r.max_new_tokens)[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 1024)])
def test_cuda_flash_attention_matches_cpu(cuda_device, causal, window):
    """The chunked training attention at S = 2048 (two key chunks), f32:
    the output and the q, k, v gradients on the card against the CPU,
    rtol 1e-5 with a floor of 1e-5 of each tensor's largest magnitude
    (each device sums a matmul in its own order)."""
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn((1, 2048, 4, 16), generator=g)
                     for _ in range(4))

    def run(dev):
        qq, kk, vv = (t.to(dev).requires_grad_(True) for t in (q, k, v))
        pos = torch.arange(2048, dtype=torch.int32, device=dev)
        out = L.flash_attention(qq, kk, vv, pos, causal, window, 1024)
        grads = torch.autograd.grad(out, (qq, kk, vv), dout.to(dev))
        return [t.detach().cpu() for t in (out,) + grads]

    for a, b in zip(run(cuda_device), run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def _tiny_dense(layers=2):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model

    return build_model(ModelConfig(
        name="t", family="dense", num_layers=layers, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        max_seq_len=64, dtype=torch.float32, param_dtype=torch.float32))


@pytest.mark.cuda
def test_cuda_stacked_fsdp_matches_cpu_and_replicated(cuda_device):
    """Dense sync with fsdp over StackedCollectives(2), 3 steps from the
    same weights: on the card against the CPU, and against the card's
    replicated dense step (losses within rtol 1e-5, the gathered params
    within rtol 1e-5 and a floor of 1e-5 of each tensor's largest
    magnitude)."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    model = _tiny_dense()
    params = model.init(torch.Generator().manual_seed(0), device="cpu")

    def run(dev, fsdp):
        tcfg = TrainConfig(sync=SyncConfig(mode="dense"), microbatches=2,
                           fsdp=fsdp)
        tr = Trainer(model, tcfg, DataConfig(8, 16, 256), dp_total=2,
                     device=dev)
        tr.init(params=_to(params, dev))
        losses = tr.run(3).losses
        whole = tr.state.params
        if fsdp:
            whole = ts.gather_params(whole, tr.fsdp_layout,
                                     StackedCollectives(2, dev))
        return losses, [t.cpu().numpy() for t in tree_leaves(whole)]

    card = run(cuda_device, True)
    for want in (run("cpu", True), run(cuda_device, False)):
        np.testing.assert_allclose(card[0], want[0], rtol=1e-5)
        for a, b in zip(card[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))


@pytest.mark.cuda
def test_cuda_process_group_checkpoint_round_trip(cuda_device, tmp_path):
    """A one-process NCCL group, SparCML through the kernels: a
    checkpoint at step 2 holds the stacked run's arrays, and a fresh
    process-group Trainer resumed from it runs to step 4 bit-equal to
    the stacked run continued."""
    import torch.distributed as dist

    from repro_torch.comm.collectives import ProcessGroupCollectives
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    tcfg = TrainConfig(sync=SyncConfig(
        mode="sparcml", k_per_bucket=4, bucket_size=128,
        algorithm="dsar_split_allgather", qsgd_bits=4, qsgd_bucket=128,
        min_sparse_size=1024), microbatches=2)
    model = _tiny_dense()

    def trainer(coll, where):
        return Trainer(model, tcfg, DataConfig(8, 16, 256), dp_total=1,
                       device=cuda_device, lowering="manual", coll=coll,
                       ckpt_dir=str(tmp_path / where))

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rv",
                            world_size=1, rank=0)
    try:
        coll = ProcessGroupCollectives(device=cuda_device)
        pg = trainer(coll, "pg")
        pg.init()
        pg.run(2)
        resumed = trainer(coll, "pg")
        assert resumed.init_or_resume() == 2
        before = topk_ops.bucket_topk.launches
        resumed.run(4)
        assert topk_ops.bucket_topk.launches > before
    finally:
        dist.destroy_process_group()
    stacked = trainer(None, "stacked")
    stacked.init()
    stacked.run(2)
    step2 = "step_00000002/arrays.npz"
    with np.load(tmp_path / "pg" / step2) as a, \
            np.load(tmp_path / "stacked" / step2) as b:
        assert a.files == b.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    stacked.run(4)
    for f in ("params", "opt", "residuals"):
        for a, b in zip(tree_leaves(getattr(resumed.state, f)),
                        tree_leaves(getattr(stacked.state, f))):
            assert torch.equal(a, b), f


@pytest.mark.cuda
def test_cuda_own_rank_bits_are_slices_of_the_stacked_draw(cuda_device):
    """Rank r's default QSGD bits, drawn alone (n words), are slice r of
    the stacked draw on the card, which fills each rank's slice in
    place."""
    from repro_torch.train import train_step as ts

    bits = ts.StepBits(0, 3, cuda_device, 4)
    for b, n in ((0, 4096), (7, 1000)):
        full = bits(b, 4 * n)
        for r in range(4):
            assert torch.equal(bits.rank_fn(r)(b, n), full[r * n:(r + 1) * n])
