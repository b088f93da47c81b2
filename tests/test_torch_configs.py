"""The port's config registry (``repro_torch.configs``) against the JAX
package's ``repro.configs``.

Everything here is compared exactly: names, shapes, every field of the
ten configs (dtypes mapped jnp -> torch), the analytic parameter counts,
the full configs' parameter trees (built on the meta device against the
reference's ``jax.eval_shape``), the applicability table and the
training configs' knobs. The one intended difference is
``SyncConfig.impl``: "auto" in the port, "ref" in the reference (see
``repro_torch/configs/_common.py``). The ports of the reference's
``tests/test_models_smoke.py`` run every arch's smoke config: a forward
(shapes, finite) and a backtracked descent step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models.model import build_model as jax_build_model
from repro_torch import configs as tc
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

MOE_ARCHS = ["moonshot-v1-16b-a3b", "dbrx-132b"]
ARCHS = [jc.EXTERNAL_NAMES[a] for a in jc.ARCH_IDS]
FAMILY_ARCHS = [a for a in ARCHS if a not in MOE_ARCHS]
# train configs with SparCML sync (llama3-405b's and dbrx's ask for fsdp)
FSDP_ARCHS = ["llama3-405b", "dbrx-132b"]
SPARCML_ARCHS = [a for a in ARCHS if a not in FSDP_ARCHS]
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
    assert set(tc.PORTED) == set(jc.ARCH_IDS)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_family_configs_match_reference_field_for_field(arch, which):
    """The other eight archs, by either name, as the MoE ones below."""
    mod = tc.get_module(arch).__name__.rsplit(".", 1)[1]
    assert tc.get_module(mod) is tc.get_module(arch)
    if which == "full":
        cfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    else:
        cfg, jcfg = tc.smoke_config(arch), jc.smoke_config(arch)
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert (cfg.d_inner, cfg.ssm_heads, cfg.is_decoder, cfg.subquadratic) \
        == (jcfg.d_inner, jcfg.ssm_heads, jcfg.is_decoder, jcfg.subquadratic)
    assert _fields(tc.get_config(arch, num_layers=2)) == \
        _fields(jc.get_config(arch, num_layers=2))


def test_zamba2_long_context_window():
    """zamba2's long-context form: a 4096-token sliding window on the
    shared attention, as the reference's."""
    cfg = tc.get_module("zamba2-2.7b").config(long_context=True)
    jcfg = jc.get_module("zamba2-2.7b").config(long_context=True)
    assert cfg.sliding_window == 4096
    assert _fields(cfg) == _fields(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_params_on_meta_match_reference(arch):
    """Every full config's parameter tree built on the meta device (no
    memory) has the reference's leaves: paths, shapes and dtypes, from
    ``jax.eval_shape`` of its init; and as many entries."""
    shapes = build_model(tc.get_config(arch)).init(device="meta")
    want = jax.eval_shape(jax_build_model(jc.get_config(arch)).init,
                          jax.random.PRNGKey(0))
    jl, _ = jax.tree.flatten_with_path(want)
    leaves, paths = tree_flatten(shapes)
    assert [tuple(p) for p in paths] == [
        tuple(str(getattr(k, "key", k)) for k in p) for p, _ in jl]
    assert [tuple(t.shape) for t in leaves] == [a.shape for _, a in jl]
    assert [DTYPES[a.dtype.type] if a.dtype.type in DTYPES else
            torch.float32 for _, a in jl] == [t.dtype for t in leaves]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == sum(
        int(np.prod(a.shape)) for _, a in jl)


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


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", SPARCML_ARCHS)
def test_sparcml_train_configs_match_reference(arch):
    """Each SparCML arch's train_config: the reference's sync (but impl),
    schedule, optimizer, microbatches and ZeRO-1."""
    t, j = tc.get_train_config(arch), jc.get_train_config(arch, None)
    sync, jsync = dataclasses.asdict(t.sync), dataclasses.asdict(j.sync)
    assert sync.pop("impl") == "auto" and jsync.pop("impl") == "ref"
    sync.pop("ef_dtype"), jsync.pop("ef_dtype")
    assert sync == jsync
    assert dataclasses.asdict(t.schedule) == dataclasses.asdict(j.schedule)
    opt, jopt = dataclasses.asdict(t.optimizer), dataclasses.asdict(
        j.optimizer)
    assert DTYPES[jopt.pop("state_dtype")] == opt.pop("state_dtype")
    assert opt == jopt
    assert (t.microbatches, t.zero1) == (j.microbatches, j.zero1)
    assert t.zero1 and t.sync.mode == "sparcml"


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_train_configs_match_reference(arch):
    """llama3-405b's and dbrx's train_config: dense sync with fsdp
    (ZeRO-3) and bf16 moments, the reference's schedule, optimizer and
    microbatches, and the same sync fields (but impl)."""
    t, j = tc.get_train_config(arch), jc.get_train_config(arch, None)
    sync, jsync = dataclasses.asdict(t.sync), dataclasses.asdict(j.sync)
    assert sync.pop("impl") == "auto" and jsync.pop("impl") == "ref"
    sync.pop("ef_dtype"), jsync.pop("ef_dtype")
    assert sync == jsync and t.sync.mode == "dense"
    assert dataclasses.asdict(t.schedule) == dataclasses.asdict(j.schedule)
    opt, jopt = dataclasses.asdict(t.optimizer), dataclasses.asdict(
        j.optimizer)
    assert DTYPES[jopt.pop("state_dtype")] == opt.pop("state_dtype")
    assert opt == jopt and t.optimizer.state_dtype == torch.bfloat16
    assert (t.microbatches, t.fsdp, t.zero1) == (
        j.microbatches, j.fsdp, j.zero1)
    assert t.fsdp and not t.zero1


def _smoke_batch(cfg, rng, b=2, s=16) -> dict:
    """The reference smoke test's batch, drawn with numpy: random tokens
    and labels, image embeddings (vlm) and frames (encoder)."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encoder":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_shapes_no_nans(arch):
    """The reference's tests/test_models_smoke.py forward test."""
    cfg = tc.smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    logits = model(params, _smoke_batch(cfg, np.random.default_rng(0)))
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert torch.isfinite(logits).all(), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_one_train_step(arch):
    """The reference's tests/test_models_smoke.py descent test: a finite
    loss and non-zero grad norm, and a normalized SGD step that, for one
    of the scales 0.1, 0.03, 0.01, lowers the loss."""
    cfg = tc.smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    batch = _smoke_batch(cfg, np.random.default_rng(1))
    leaves, paths = tree_flatten(params)
    live = [p.clone().requires_grad_(True) for p in leaves]
    loss = model.loss(tree_unflatten(paths, live), batch)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(loss, live, allow_unused=True), live)]
    assert torch.isfinite(loss)
    gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    assert np.isfinite(gnorm) and gnorm > 0
    descended = False
    with torch.no_grad():
        for scale in (0.1, 0.03, 0.01):
            step = scale / (gnorm + 1e-9)
            new = tree_map(lambda p, g: p - step * g.to(p.dtype), params,
                           tree_unflatten(paths, grads))
            loss2 = model.loss(new, batch)
            assert torch.isfinite(loss2)
            if float(loss2) < float(loss):
                descended = True
                break
    assert descended, f"{arch}: no backtracked descent step reduced loss"
