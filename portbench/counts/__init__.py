"""Operations and bytes, counted from the configuration and the plan's
bucket shapes, never from what an implementation happens to run.

``step_flops``: the model's FLOPs of one training step, 3 x the forward
(the backward twice the forward), remat's recompute not counted. The
forward counts every matrix product of the model at 2 FLOPs a
multiply-add: the projections each token passes through (routed experts
at ``experts_per_token``, not at capacity slots; the output head at the
vocabulary's size), attention's score and value products over the causal
half. The embedding lookup, norms and activations are not counted.

``sync_bytes``: what the four SparCML kernels of one step must read and
write, each input byte once and each output byte once, from the plan's
buckets: ``bucket_topk`` reads every rank's accumulator and writes its
residual and its k (value, index) pairs of every bucket_size entries;
``bucket_scatter_sum`` reads those pairs and writes the sum; ``qsgd_pack``
reads the sum and its rounding words and writes the codes and a scale a
QSGD row; ``qsgd_unpack`` reads those and writes the reduced buffer.
"""
from __future__ import annotations


def _attn_macs_per_token(dims: dict, seq: int) -> float:
    """Scores and values over the causal half: 2 products x nh x hd x
    (S + 1) / 2 keys a query on average."""
    return 2 * dims["num_heads"] * dims["head_dim"] * (seq + 1) / 2


def _attn_proj(dims: dict) -> int:
    d, nh, nkv, hd = (dims["d_model"], dims["num_heads"],
                      dims["num_kv_heads"], dims["head_dim"])
    return d * nh * hd * 2 + d * nkv * hd * 2


def forward_macs_per_token(dims: dict, seq: int) -> float:
    d, fam = dims["d_model"], dims["family"]
    head = d * dims["vocab_size"]
    attn = _attn_proj(dims) + _attn_macs_per_token(dims, seq)
    if fam == "moe":
        layer = (attn + d * dims["num_experts"]
                 + dims["experts_per_token"] * 3 * d * dims["moe_d_ff"]
                 + 3 * d * dims["moe_shared_ff"])
        return dims["num_layers"] * layer + head
    raise ValueError(f"no FLOP count for family {fam!r}")


def step_flops(dims: dict, traffic: dict) -> float:
    tokens = traffic["global_batch"] * traffic["seq_len"]
    return 3 * 2 * forward_macs_per_token(dims, traffic["seq_len"]) * tokens


def sync_bytes(buckets: list, ranks: int, sync: dict) -> dict:
    """Bytes a step, by kernel. ``buckets``: (rows, cols, ef, quantized)
    of each bucket of the plan; a bucket without EF state runs none of
    the four kernels."""
    k, b = sync["k_per_bucket"], sync["bucket_size"]
    bits, qb = sync["qsgd_bits"], sync["qsgd_bucket"]
    out = {"bucket_topk": 0, "bucket_scatter_sum": 0, "qsgd_pack": 0,
           "qsgd_unpack": 0}
    for rows, cols, ef, quantized in buckets:
        if not ef:
            continue
        n = rows * cols
        pairs = ranks * (n // b) * k * 8            # f32 value + i32 index
        out["bucket_topk"] += ranks * n * 4 * 2 + pairs
        out["bucket_scatter_sum"] += pairs + n * 4
        if quantized:
            codes = n * bits // 8 + (n // qb) * 4
            out["qsgd_pack"] += n * 4 * 2 + codes
            out["qsgd_unpack"] += codes + n * 4
    return out
