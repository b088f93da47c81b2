"""Architecture registry: the 10 assigned configs and the input-shape sets
(the JAX package's ``repro.configs``).

Every arch is named by its module id or its external (hyphenated) name.
Only the MoE family's configs are ported so far (moonshot-v1-16b-a3b and
dbrx-132b); asking for another arch raises ``NotImplementedError``,
naming ROADMAP Queue 1 item 12b. Applicability rules as the reference's:
decode shapes only for decoders, long_500k only for sub-quadratic
families.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

ARCH_IDS = [
    "llama32_vision_11b",
    "mamba2_370m",
    "minicpm_2b",
    "qwen3_4b",
    "llama3_405b",
    "internlm2_20b",
    "dbrx_132b",
    "moonshot_v1_16b_a3b",
    "zamba2_2p7b",
    "hubert_xlarge",
]

# canonical external names (hyphenated, as assigned)
EXTERNAL_NAMES = {
    "llama32_vision_11b": "llama-3.2-vision-11b",
    "mamba2_370m": "mamba2-370m",
    "minicpm_2b": "minicpm-2b",
    "qwen3_4b": "qwen3-4b",
    "llama3_405b": "llama3-405b",
    "internlm2_20b": "internlm2-20b",
    "dbrx_132b": "dbrx-132b",
    "moonshot_v1_16b_a3b": "moonshot-v1-16b-a3b",
    "zamba2_2p7b": "zamba2-2.7b",
    "hubert_xlarge": "hubert-xlarge",
}
_BY_EXTERNAL = {v: k for k, v in EXTERNAL_NAMES.items()}
# the arch modules the port has
PORTED = ("dbrx_132b", "moonshot_v1_16b_a3b")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_module(arch: str):
    mod = _BY_EXTERNAL.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if mod not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r}: its config is not ported yet (ROADMAP Queue 1 "
            "item 12b)")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str, **overrides):
    return get_module(arch).config(**overrides)


def get_train_config(arch: str, **overrides):
    return get_module(arch).train_config(**overrides)


def smoke_config(arch: str):
    return get_module(arch).smoke_config()


def applicable_shapes(arch: str) -> dict:
    """shape -> (applicable: bool, reason-if-skipped)."""
    cfg = get_config(arch)
    out = {}
    for name, sh in SHAPES.items():
        if sh.kind == "decode" and not cfg.is_decoder:
            out[name] = (False, "encoder-only: no autoregressive decode")
        elif name == "long_500k" and not cfg.subquadratic:
            out[name] = (False, "pure full-attention: no sub-quadratic path")
        else:
            out[name] = (True, "")
    return out
