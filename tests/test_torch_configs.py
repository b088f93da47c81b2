"""The port's config registry (``repro_torch.configs``) against the JAX
package's ``repro.configs``.

Everything here is compared exactly: names, shapes, every field of the
ported configs (dtypes mapped jnp -> torch), the analytic parameter
counts, the applicability table and the training configs' knobs. The
one intended difference is ``SyncConfig.impl``: "auto" in the port, "ref"
in the reference (see ``repro_torch/configs/_common.py``).
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jc
from repro_torch import configs as tc
from repro_torch.models.model import build_model

MOE_ARCHS = ["moonshot-v1-16b-a3b", "dbrx-132b"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    for k, v in out.items():
        if k in ("dtype", "param_dtype"):
            out[k] = DTYPES.get(v, v)
    out.pop("act_dp_axes", None)        # the reference's sharding knob
    return out


def test_registry_names_and_shapes_match_reference():
    assert tc.ARCH_IDS == jc.ARCH_IDS
    assert tc.EXTERNAL_NAMES == jc.EXTERNAL_NAMES
    assert {k: dataclasses.astuple(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jc.SHAPES.items()}
    assert set(tc.PORTED) == {"dbrx_132b", "moonshot_v1_16b_a3b"}


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2_370m", "zamba2-2.7b",
                                  "hubert-xlarge", "llama-3.2-vision-11b"])
def test_unported_archs_raise_naming_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="item 12b"):
        tc.get_config(arch)
    with pytest.raises(NotImplementedError, match="item 12b"):
        tc.smoke_config(arch)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_module("gpt-5")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_moe_configs_match_reference_field_for_field(arch, which):
    if which == "full":
        cfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    else:
        cfg, jcfg = tc.smoke_config(arch), jc.smoke_config(arch)
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.padded_vocab == jcfg.padded_vocab
    # overrides reach the config as in the reference
    assert _fields(tc.get_config(arch, num_layers=1)) == \
        _fields(jc.get_config(arch, num_layers=1))


def test_full_configs_match_assignment():
    """The assigned numbers of the two MoE archs
    (tests/test_models_smoke.py's table)."""
    expect = {
        "dbrx-132b": dict(num_layers=40, d_model=6144, num_heads=48,
                          num_kv_heads=8, vocab_size=100352, num_experts=16,
                          experts_per_token=4, moe_d_ff=10752),
        "moonshot-v1-16b-a3b": dict(num_layers=48, d_model=2048,
                                    num_heads=16, num_kv_heads=16,
                                    vocab_size=163840, num_experts=64,
                                    experts_per_token=6, moe_d_ff=1408,
                                    moe_shared_ff=2816, head_dim=128),
    }
    for arch, fields in expect.items():
        cfg = tc.get_config(arch)
        assert cfg.family == "moe"
        assert cfg.dtype == cfg.param_dtype == torch.bfloat16
        for f, v in fields.items():
            assert getattr(cfg, f) == v, (arch, f)
    assert 1.2e11 <= tc.get_config("dbrx-132b").param_count() <= 1.45e11
    assert 2.5e10 <= tc.get_config(
        "moonshot-v1-16b-a3b").param_count() <= 3.2e10


def test_moonshot_full_width_sizes():
    """The full-width sizes the card's smoke trains at one layer: the
    embedding and unembedding 671.1 M, the layer 587.9 M (its 64 experts
    553.6 M, 94 %), 1,258,952,704 entries in all."""
    cfg = tc.get_config("moonshot-v1-16b-a3b", num_layers=1)
    shapes = build_model(cfg).init(device="meta")
    layer = sum(t.numel() for t in _leaves(shapes["blocks"]))
    experts = sum(shapes["blocks"]["moe"][k].numel()
                  for k in ("wi", "wg", "wo"))
    assert shapes["embed"].numel() + shapes["unembed"].numel() == \
        671_088_640
    assert layer == 587_862_016 and experts == 553_648_128
    # param_count leaves out the three norms' scales
    assert sum(t.numel() for t in _leaves(shapes)) == 1_258_952_704 == \
        cfg.param_count() + 3 * 2048


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_applicable_shapes_match_reference(arch):
    assert tc.applicable_shapes(arch) == jc.applicable_shapes(arch)


def test_moonshot_train_config_matches_reference():
    t = tc.get_train_config("moonshot-v1-16b-a3b")
    j = jc.get_train_config("moonshot-v1-16b-a3b", None)
    sync = dataclasses.asdict(t.sync)
    jsync = dataclasses.asdict(j.sync)
    assert sync.pop("impl") == "auto" and jsync.pop("impl") == "ref"
    sync.pop("ef_dtype"), jsync.pop("ef_dtype")
    assert sync == jsync
    assert (t.sync.mode, t.sync.algorithm, t.sync.qsgd_bits,
            t.sync.k_per_bucket, t.sync.bucket_size) == (
        "sparcml", "dsar_split_allgather", 4, 4, 512)
    assert dataclasses.asdict(t.schedule) == dataclasses.asdict(j.schedule)
    opt, jopt = dataclasses.asdict(t.optimizer), dataclasses.asdict(
        j.optimizer)
    assert DTYPES[jopt.pop("state_dtype")] == opt.pop("state_dtype")
    assert opt == jopt
    assert (t.microbatches, t.zero1) == (j.microbatches, j.zero1) == (4, True)
    assert tc.get_train_config("moonshot-v1-16b-a3b",
                               microbatches=2).microbatches == 2


def test_dbrx_train_config_raises_for_fsdp():
    """dbrx's train_config asks for fsdp (ZeRO-3 placement), which the port
    does not have: it raises, naming the ROADMAP item."""
    with pytest.raises(NotImplementedError, match="item 10"):
        tc.get_train_config("dbrx-132b")


def test_moe_entry_points_default_to_the_card(monkeypatch):
    """init_params, the decode state and the engines of a MoE model run on
    the card unless device="cpu" is given, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(tc.smoke_config("moonshot-v1-16b-a3b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_decode_state(2, 8)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["blocks"]["moe"]["wi"].shape == (4, 8, 64, 32)
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
