"""Train state + top-level training configuration."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

from repro_torch.core.compressor import SyncConfig
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig


class TrainState(NamedTuple):
    params: Any          # dict tree of tensors (JAX package layout); under
                         # fsdp each leaf the held ranks' shards
                         # (models.specs.fsdp_layout)
    opt: Any             # {"mu", ["nu"], "count"}: param-shaped moments
                         # ("full"), per-leaf (ranks, rows, cols/dp)
                         # canonical chunks ("zero1_leaf"), or per-bucket
                         # (ranks, rows, cols/dp) owned chunks
                         # ("zero_scattered"); see checkpoint.opt_layout_of
    residuals: Any       # EF state: bucket-keyed {name: (dp, rows, cols)}
                         # from the SyncPlan (sparcml) or None
    step: int
    inflight: Any = None # non-blocking runtime: bucket-keyed {name: (rows,
                         # cols)} REDUCED buffers of the previous step plus
                         # the validity flag, applied this step
                         # (staleness 1): the scattered output mode holds
                         # (ranks, rows, cols/dp) owner chunks instead;
                         # None when synchronous. Stripped before
                         # checkpointing.


@dataclass(frozen=True)
class TrainConfig:
    sync: SyncConfig = field(default_factory=SyncConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    microbatches: int = 1            # gradient-accumulation steps
    fsdp: bool = False               # ZeRO-3: params and moments sharded
                                     # over the ranks (dense mode only)
    zero1: bool = True               # shard the optimizer moments over the
                                     # data-parallel ranks (sparcml mode)
    seed: int = 0

    def __post_init__(self):
        if self.fsdp and self.sync.mode == "sparcml":
            raise ValueError(
                "sparcml sync requires DP-replicated params (fsdp=False): "
                "per-rank error-feedback residuals are O(model) per rank and "
                "cannot compose with ZeRO-3 sharding — see DESIGN.md "
                "§Arch-applicability and the paper's §8.4 ResNet50 discussion."
            )
