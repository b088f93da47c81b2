"""Cells cut to a size the CPU tests hold: the real cell's files with the
model's widths and the batch shrunk, every path of the run kept (the
sync's sparse buckets too: ``min_sparse_size`` and the fusion size cut
with the widths), in float32 by default: the cells' limits are set for
bf16 at full size, and at a tiny size a sound bf16 run reads above them,
where a float32 one reads rounding alone."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import spec

MOE = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
           vocab_size=512, num_experts=8, experts_per_token=2, moe_d_ff=32,
           moe_shared_ff=64)
CELLS = {"moonshot-sparcml-r2": (MOE, dict(global_batch=4, seq_len=16,
                                           microbatches=2))}


def cell(name: str, dtype: str = "float32") -> spec.Cell:
    fields, traffic = CELLS[name]
    real = spec.cell(name)
    conf = copy.deepcopy(real.config)
    fields = dict(fields, dtype=dtype, param_dtype=dtype)
    conf["port"]["overrides"] = dict(fields)
    conf["port"]["fields"].update(fields)
    conf["port"]["published"] = {}
    tr = copy.deepcopy(real.traffic)
    tr.update(traffic)
    tr["sync"] = dict(tr["sync"], min_sparse_size=1024,
                      fusion_bucket_bytes=1 << 15)
    return spec.Cell(real.name, real.chips, real.config_name, conf,
                     real.traffic_name, tr, real.limits, real.end_to_end,
                     real.per_layer)


@pytest.fixture(autouse=False)
def one_thread():
    """Tiny tensors on one intra-op thread: several test workers share the
    host's cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
