"""The one-card dry run, op counter and roofline against the JAX
package's ``launch/dryrun.py``, ``utils/hlo_cost.py`` and
``utils/roofline.py``, on the CPU (the port on the meta device)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import make_mesh
from repro.models.model import build_model as jax_build_model
from repro.utils import roofline as jroofline
from repro.utils.hlo_cost import total_cost
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models.model import build_model, init_params
from repro_torch.utils import op_cost, roofline


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dryrun module: importing it sets XLA_FLAGS for
    512 devices (which the JAX already running here ignores); put the
    variable back for whatever this process starts later."""
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return mod


def test_state_memory_breakdown_matches_reference_per_rank(jdryrun):
    """One rank a process, p = 4, against the reference's breakdown on a
    mesh of data 4 x model 1, component by component: params whole,
    ZeRO-1 moments and EF residuals one rank's share, the in-flight
    buffers whole (replicated). The stacked layout holds all four ranks'
    residuals and moment chunks: 4 x the per-rank ones."""
    arch = "qwen3-4b"
    mesh = make_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])
    ref = jdryrun.state_memory_breakdown(
        jax_build_model(jconfigs.smoke_config(arch)),
        jconfigs.get_train_config(arch), mesh)
    model = build_model(configs.smoke_config(arch))
    tcfg = configs.get_train_config(arch)
    per_rank = dryrun.state_memory_breakdown(model, tcfg, 4, ranks=1)
    assert per_rank == {k: int(v) for k, v in ref.items()}
    stacked = dryrun.state_memory_breakdown(model, tcfg, 4)
    for k in ("opt_mu", "opt_nu", "ef_residual"):
        assert stacked[k] == 4 * per_rank[k]
    for k in ("params", "inflight"):
        assert stacked[k] == per_rank[k]


def test_fsdp_state_memory_breakdown_matches_reference_per_rank(jdryrun):
    """fsdp (llama3-405b's train_config: dense sync, bf16 moments) at
    p = 2: one rank a process holds half of each sharded leaf and every
    replicated leaf whole, params and moments alike: the reference's
    breakdown on a data 2 x model 1 mesh, component by component. The
    stacked ranks hold both halves: the replicated layout's bytes."""
    arch = "llama3-405b"
    mesh = make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2])
    ref = jdryrun.state_memory_breakdown(
        jax_build_model(jconfigs.smoke_config(arch)),
        jconfigs.get_train_config(arch, mesh), mesh)
    model = build_model(configs.smoke_config(arch))
    tcfg = configs.get_train_config(arch)
    per_rank = dryrun.state_memory_breakdown(model, tcfg, 2, ranks=1)
    assert per_rank == {k: int(v) for k, v in ref.items()}
    stacked = dryrun.state_memory_breakdown(model, tcfg, 2)
    whole = dryrun.state_memory_breakdown(
        model, dataclasses.replace(tcfg, fsdp=False), 2)
    assert stacked == whole
    assert per_rank["params"] < stacked["params"] < 2 * per_rank["params"]


@pytest.mark.parametrize("arch,sync", [("dbrx-132b", None),
                                       ("qwen3-4b", "dense")])
def test_run_cell_trains_fsdp(arch, sync, tmp_path):
    """dbrx's own train cell (fsdp) and qwen3-4b's under the reference's
    --sync dense override count at 1 layer: status ok, a rank's share of
    the state, the gathered params in the peak."""
    rec = dryrun.run_cell(arch, "train_4k", layers=1, out_dir=str(tmp_path),
                          sync_override=sync)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["fsdp"] and rec["sync_mode"] == "dense"
    sm, mine = rec["state_memory"], rec["state_memory_per_rank"]
    assert rec["gathered_params"] == sm["params"] > mine["params"]
    assert mine["opt_mu"] < sm["opt_mu"] and sm["ef_residual"] == 0
    tag = f"__{sync}" if sync else ""
    assert (tmp_path / f"{arch}__train_4k__stacked2{tag}.json").exists()


def _counted_forward(arch, b, s):
    cfg = configs.smoke_config(arch)
    model = build_model(cfg)
    params = init_params(cfg, device="meta")
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                   device="meta")}
    with torch.no_grad():
        cost, _ = op_cost.count(model.forward, params, batch)
    return cost


def _reference_flops(arch, b, s, grad):
    jmodel = jax_build_model(jconfigs.smoke_config(arch))
    pshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if grad:
        fn = jax.jit(lambda p, t: jax.grad(
            lambda q: jmodel.loss(q, {"tokens": t, "labels": t}))(p))
    else:
        fn = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}))
    return total_cost(fn.lower(pshapes, toks).compile().as_text()).flops


def test_matmul_flops_match_reference_hlo_cost():
    """The counted matmul FLOPs of qwen3-4b's smoke forward equal the
    reference's trip-aware dot FLOPs of the same jitted forward within 1
    % (measured: equal). Forward + backward (remat on in both): within
    5 %. XLA drops a recomputed dot whose result the backward never
    reads (each block's last projection, the MLP's down-projection), and
    eager PyTorch's recompute runs the whole block: measured +4.17 %,
    exactly the 4 blocks' 2·(b·s)·d_ff·d."""
    b, s = 2, 64
    fwd = _counted_forward("qwen3-4b", b, s)
    assert fwd.other_flops == 0 and fwd.ops > 0 and fwd.bytes > 0
    np.testing.assert_allclose(fwd.flops, _reference_flops(
        "qwen3-4b", b, s, grad=False), rtol=0.01)
    cfg = configs.smoke_config("qwen3-4b")
    batch = dryrun.batch_shapes(cfg, b, s)
    both = op_cost.microbatch_cost(build_model(cfg), batch)
    np.testing.assert_allclose(both.flops, _reference_flops(
        "qwen3-4b", b, s, grad=True), rtol=0.05)


def test_roofline_terms_on_hand_computed_inputs():
    r = roofline.Roofline(flops=989e12 * 2, hbm_bytes=3.35e12 * 3,
                          coll_bytes_per_chip=450e9 * 0.5, chips=1,
                          model_flops=989e12)
    assert (r.t_compute, r.t_memory, r.t_collective) == (2.0, 3.0, 0.5)
    assert r.bound == 3.0 and r.serial_bound == 5.5
    assert r.dominant == "memory"
    assert r.useful_flops_ratio == 0.5
    assert r.mfu_bound == pytest.approx(1 / 3)
    f32 = roofline.Roofline(flops=67e12 * 4, hbm_bytes=0,
                            coll_bytes_per_chip=0, chips=2,
                            model_flops=67e12,
                            peak_flops=roofline.compute_peak(
                                roofline.H100, torch.float32))
    assert f32.t_compute == 2.0 and f32.dominant == "compute"
    assert f32.mfu_bound == pytest.approx(0.25)
    h100 = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert (h100.bf16, h100.tf32, h100.f32, h100.hbm, h100.link) == (
        989e12, 495e12, 67e12, 3.35e12, 450e9)
    assert roofline.peaks_for("NVIDIA H100 PCIe").hbm == 2.0e12
    assert roofline.compute_peak(h100, torch.bfloat16) == 989e12
    assert roofline.compute_peak(h100, torch.float32) == 67e12
    with pytest.raises(KeyError):
        roofline.peaks_for("NVIDIA A100-SXM4-80GB")
    for n, d in ((979_763_200, 65_536), (1, 1)):
        assert roofline.model_flops_train(n, d) == \
            jroofline.model_flops_train(n, d)
        assert roofline.model_flops_infer(n, d) == \
            jroofline.model_flops_infer(n, d)


@pytest.mark.parametrize("arch,shape", [("hubert-xlarge", "decode_32k"),
                                        ("qwen3-4b", "long_500k")])
def test_run_cell_skips_what_the_reference_skips(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, out_dir=str(tmp_path))
    reason = configs.applicable_shapes(arch)[shape][1]
    assert rec["status"] == "skipped" and rec["reason"] == reason
    assert (tmp_path / f"{arch}__{shape}__stacked2.json").exists()


def test_run_cell_train_4k_cut_to_one_layer(tmp_path, capsys):
    """qwen3-4b at train_4k, cut to 1 layer, 2 stacked ranks: the record
    holds the state, the counted step, the plan's wire bytes, model
    FLOPs and a bf16 roofline; the report prints its row."""
    from repro_torch.launch import roofline_report

    rec = dryrun.run_cell("qwen3-4b", "train_4k", dp_total=2, layers=1,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["reduced"] == "depth 36 -> 1 layers"
    assert rec["microbatches"] == 8 and rec["rows_per_microbatch"] == 16
    assert rec["tokens"] == 256 * 4096
    assert rec["cost"]["flops"] == 16 * rec["counted"]["flops"]
    assert rec["model_flops"] == 6 * rec["active_params"] * 256 * 4096
    assert rec["roofline"]["peak_flops"] == 989e12
    assert rec["wire_bytes"] == sum(rec["wire_bytes_by_bucket"].values())
    assert 1.0 < rec["remat_dup"] < 4 / 3
    sm = rec["state_memory"]
    assert sm["total"] == sum(v for k, v in sm.items() if k != "total")
    assert rec["fits"] == (rec["peak_estimate"] <= 80e9)
    roofline_report.main(["--dir", str(tmp_path), "--full"])
    out = capsys.readouterr().out
    assert "| qwen3-4b | train_4k |" in out and "^ " in out


@pytest.mark.parametrize("arch,shape,layers,kept", [
    ("llama-3.2-vision-11b", "decode_32k", 2, 5),   # whole superblocks
    ("mamba2-370m", "long_500k", 1, 1),
    ("hubert-xlarge", "prefill_32k", 1, 1)])
def test_run_cell_serving_shapes(arch, shape, layers, kept):
    """Prefill (the encoder: its forward) and decode cells count on the
    meta device: 2·N·D model FLOPs, the params and caches held, the depth
    cut to whole superblocks."""
    rec = dryrun.run_cell(arch, shape, layers=layers)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["reduced"].endswith(f"-> {kept} layers")
    sh = configs.SHAPES[shape]
    tokens = sh.global_batch * (sh.seq_len if sh.kind == "prefill" else 1)
    assert rec["tokens"] == tokens
    assert rec["model_flops"] == 2 * rec["active_params"] * tokens
    sm = rec["state_memory"]
    assert sm["total"] == sm["params"] + sm["cache"]
    assert (sm["cache"] > 0) == (sh.kind == "decode")
    assert rec["cost"]["flops"] > 0
