"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test skips without CUDA. The file imports no JAX, so it runs on a
machine with a GPU and without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: bit-equal, except bucket_scatter with duplicate indices
(allclose, atol=1e-6: the adds of one row run in j order in both, but
the plain version adds through scatter_add_). The grouped unpack sums
two pods, and a two-term sum has one rounding in any order, so it is
bit-equal too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bucket_scatter import ops as scatter_ops
from repro_torch.kernels.bucket_topk import ops as topk_ops
from repro_torch.kernels.bucket_topk.cases import adversarial_rows
from repro_torch.kernels.qsgd_pack import ops as pack_ops
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
                              1000)
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
