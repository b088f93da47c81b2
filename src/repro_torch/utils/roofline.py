"""Three-term roofline of a step on NVIDIA cards (the JAX package's
``repro.utils.roofline``, with the card's published peaks in place of a
TPU's):

  compute    = FLOPs / (cards x peak FLOP/s for the model's compute dtype)
  memory     = bytes moved / (cards x HBM bytes/s)
  collective = wire bytes a card / NVLink bytes/s one way

The reference scores every step against one bf16 peak; here the compute
peak follows the dtype the model computes in: bf16 on the tensor cores,
f32 outside them (the port turns TF32 off, so lm-100m's f32 step is
bounded by the f32 peak; the TF32 rate is listed with the card's other
published rates and scores nothing). ``bound`` is the perfectly overlapped step time
max(terms), ``serial_bound`` their sum; ``mfu_bound`` scores the model's
FLOPs at that peak against the overlapped bound.

``PEAKS`` is the one table of peaks in the repository; ``chip_smoke.py``
reads its kernels' bounds from it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Peaks:
    """One card's published dense rates (NVIDIA data sheets, no
    sparsity, at the card's full power limit)."""
    hbm: float       # bytes/s
    f32: float       # FLOP/s, float32 outside the tensor cores
    tf32: float      # FLOP/s, TF32 tensor cores
    bf16: float      # FLOP/s, bf16 / fp16 tensor cores
    link: float      # NVLink bytes/s one way
    memory: float    # bytes of device memory


# by a substring of torch.cuda.get_device_name; the first match wins, so
# the plain "H100" (SXM, 80 GB) comes last
PEAKS = {
    "H100 PCIe": Peaks(hbm=2.0e12, f32=51e12, tf32=378e12, bf16=756e12,
                       link=300e9, memory=80e9),
    "H100 NVL": Peaks(hbm=3.9e12, f32=60e12, tf32=418e12, bf16=835e12,
                      link=300e9, memory=94e9),
    "H100": Peaks(hbm=3.35e12, f32=67e12, tf32=495e12, bf16=989e12,
                  link=450e9, memory=80e9),
}
H100 = PEAKS["H100"]


def peaks_for(name: str) -> Peaks:
    """The peaks of the card called ``name``; an unknown card raises
    rather than being measured against the wrong roofline."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise KeyError(f"no published peaks for {name!r}")


def compute_peak(peaks: Peaks, dtype: torch.dtype) -> float:
    """The FLOP/s a model computing in ``dtype`` can reach: bf16 and fp16
    on the tensor cores, f32 outside them."""
    if dtype in (torch.bfloat16, torch.float16):
        return peaks.bf16
    return peaks.f32


@dataclass(frozen=True)
class Roofline:
    flops: float                  # counted FLOPs of the step, every card
    hbm_bytes: float              # bytes moved, every card
    coll_bytes_per_chip: float    # wire bytes a card
    chips: int
    model_flops: float            # 6*N*D useful FLOPs (a step, every card)
    peak_flops: float = H100.bf16
    hbm_bw: float = H100.hbm
    link_bw: float = H100.link

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.link_bw

    @property
    def bound(self) -> float:
        """Perfect-overlap step-time lower bound."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def serial_bound(self) -> float:
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: catches remat and redundancy."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Achievable MFU at the overlapped bound."""
        t_model = self.model_flops / (self.chips * self.peak_flops)
        return t_model / self.bound if self.bound else 0.0

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound_s": self.bound,
            "serial_bound_s": self.serial_bound,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "counted_flops": self.flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "peak_flops": self.peak_flops,
        }


def model_flops_train(param_count: int, tokens: int) -> float:
    """6*N*D for a training step (fwd+bwd)."""
    return 6.0 * param_count * tokens


def model_flops_infer(param_count: int, tokens: int) -> float:
    """2*N*D for inference."""
    return 2.0 * param_count * tokens
