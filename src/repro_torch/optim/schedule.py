"""Learning-rate schedules: cosine, linear, WSD (warmup-stable-decay) and
constant, computed in f32 as the JAX package computes them."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"       # cosine | linear | wsd | constant
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    final_frac: float = 0.1    # final lr as fraction of peak
    wsd_decay_frac: float = 0.1  # last fraction of steps spent decaying


def make_schedule(cfg: ScheduleConfig):
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    def sched(step) -> torch.Tensor:
        """f32 scalar lr (on the CPU) for integer ``step``."""
        s = f32(int(step))
        warm = torch.clamp(s / max(1, cfg.warmup_steps), max=1.0)
        if cfg.kind == "constant":
            frac = f32(1.0)
        elif cfg.kind in ("linear", "cosine"):
            t = torch.clamp((s - cfg.warmup_steps)
                            / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1)
            if cfg.kind == "linear":
                frac = 1.0 - (1.0 - cfg.final_frac) * t
            else:
                frac = cfg.final_frac + (1 - cfg.final_frac) * 0.5 * (
                    1 + torch.cos(math.pi * t))
        elif cfg.kind == "wsd":
            decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
            t = torch.clamp((s - decay_start)
                            / max(1.0, cfg.total_steps - decay_start), 0, 1)
            frac = 1.0 - (1.0 - cfg.final_frac) * t
        else:
            raise ValueError(cfg.kind)
        return cfg.peak_lr * warm * frac

    return sched
