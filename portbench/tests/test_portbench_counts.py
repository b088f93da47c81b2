"""FLOP and byte counts at small shapes against hand arithmetic."""
import pytest

from portbench import counts

MOE = dict(family="moe", num_layers=2, d_model=8, num_heads=2,
           num_kv_heads=1, head_dim=4, vocab_size=32, num_experts=4,
           experts_per_token=2, moe_d_ff=6, moe_shared_ff=10)


def test_moe_flops():
    s = 6
    # a layer: q, o 8x8 each; k, v 8x4 each; router 8x4; 2 experts of
    # 3 x 8 x 6; a shared MLP of 3 x 8 x 10; scores + values 2 x 2 x 4 x
    # (6 + 1) / 2 a token; the head 8 x 32
    layer = 64 + 64 + 32 + 32 + 32 + 2 * 144 + 240 + 2 * 2 * 4 * 3.5
    per_token = 2 * layer + 256
    assert counts.forward_macs_per_token(MOE, s) == pytest.approx(per_token)
    traffic = {"global_batch": 3, "seq_len": s}
    assert counts.step_flops(MOE, traffic) == pytest.approx(
        6 * per_token * 3 * s)


def test_sync_bytes():
    sync = {"k_per_bucket": 4, "bucket_size": 512, "qsgd_bits": 4,
            "qsgd_bucket": 1024}
    # one EF bucket of 2 x 2048 over 2 ranks, quantized; one raw-dense
    # bucket (no kernels)
    got = counts.sync_bytes([(2, 2048, True, True), (1, 4096, False, False)],
                            2, sync)
    n = 4096
    pairs = 2 * (n // 512) * 4 * 8
    codes = n // 2 + (n // 1024) * 4
    assert got == {"bucket_topk": 2 * n * 8 + pairs,
                   "bucket_scatter_sum": pairs + 4 * n,
                   "qsgd_pack": 8 * n + codes, "qsgd_unpack": codes + 4 * n}
