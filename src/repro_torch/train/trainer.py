"""Synchronous training driver (the JAX package's ``Trainer.run``).

Each step takes the deterministic synthetic batch of its step number,
runs the train step, waits for its loss and records the loss and the
wall time of the step. Checkpoints, the straggler watchdog, the
pipelined runtime, observability and fault injection are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.train.state import TrainConfig, TrainState
from repro_torch.train.train_step import build_train_step, init_state


@dataclass
class TrainerLog:
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)   # seconds


class Trainer:
    """Trains ``model`` under ``tcfg`` with ``dp_total`` stacked replicas
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, model, tcfg: TrainConfig, data_cfg: DataConfig, *,
                 dp_total: int = 4, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.dp_total = dp_total
        self.log = TrainerLog()
        self.step_fn, self.plan = build_train_step(model, tcfg, dp_total,
                                                   self.device)
        self.state: Optional[TrainState] = None

    def init(self, params=None) -> int:
        self.state = init_state(self.model, self.tcfg, self.plan, self.device,
                                params=params)
        return self.state.step

    def run(self, num_steps: int, rand_fn_for_step=None) -> TrainerLog:
        """Train up to step ``num_steps`` (absolute). ``rand_fn_for_step``
        (step -> rand_fn) overrides the QSGD rounding bits."""
        if self.state is None:
            self.init()
        while self.state.step < num_steps:
            step = self.state.step
            batch = synthetic_batch(self.data_cfg, step)
            rand_fn = rand_fn_for_step(step) if rand_fn_for_step else None
            t0 = time.perf_counter()
            new_state, metrics = self.step_fn(self.state, batch, rand_fn)
            loss = float(metrics["loss"])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.state = new_state
            self.log.losses.append(loss)
            self.log.step_times.append(dt)
        return self.log
