"""One-card dry run: count what each (arch x input-shape) cell would cost
on one H100, from shapes alone (the JAX package's
``repro.launch.dryrun``, for the port's one card).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --layers 2 --dp 2
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --sync dense     # dense sync + fsdp, every arch

Everything runs on the ``meta`` device, on the CPU: the model is built
there (its init allocates nothing), the step's operations are counted by
``utils.op_cost.OpCost`` and no CUDA kernel is launched (the sync's
kernels dispatch on the device and would refuse a meta tensor, so the
sync's wire bytes come from the plan).

The port has no mesh. A cell trains ``dp_total`` data-parallel ranks
stacked on one card, as ``Trainer`` does: the card holds the params
once (under fsdp every rank's shards), every rank's EF residuals and
every rank's ZeRO-1 (or scattered) moment chunks, and runs every rank's
microbatches. Each cell writes
``<out>/<arch>__<shape>__stacked<dp>[__<sync>].json`` with
  * ``state_memory``: the card's persistent state by component
    (``state_memory_breakdown``), and ``state_memory_per_rank`` the share
    one rank a process holds (``ranks=1``: under fsdp its 1/p of the
    params and moments);
  * ``counted``: one rank's forward + backward of one microbatch (remat
    as the config says) counted by ``OpCost``; ``cost``: that times
    microbatches x ranks (train), or the forward of the whole batch
    (prefill) or one decode step (decode);
  * ``wire_bytes`` (and by bucket): the plan's gradient-exchange bytes a
    rank a step, as if each rank were a card;
  * ``model_flops`` (6·N·D train, 2·N·D prefill and decode, N the
    active parameters for MoE), the ``Roofline`` of one card with the
    H100's peaks (compute at the peak of the model's dtype),
    ``remat_dup`` (train), and a ``fits`` verdict: ``peak_estimate``
    (the state, every rank's largest live bytes of one microbatch, the
    ranks' accumulated f32 grads when there are several microbatches,
    and under fsdp the params gathered whole for the forward) against
    the card's 80 GB;
  * ``reduced``, when ``--layers`` cut the depth.
``--sync dense`` trains every cell with dense sync and fsdp (the
reference's override); ``--sync sparcml`` with the arch's own config.
The reference's lower and compile times, and XLA's memory analysis,
have no counterpart in eager PyTorch and are left out. Shapes that
``applicable_shapes`` rejects are ``skipped`` with the reason.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import configs as cfgreg
from repro_torch.core.compressor import wire_bytes_per_step
from repro_torch.models.model import build_model, init_params
from repro_torch.configs._common import make_train_config
from repro_torch.train.train_step import (build_plan, fsdp_layout_of,
                                          init_opt, shard_params)
from repro_torch.utils import op_cost
from repro_torch.utils.roofline import (H100, Roofline, compute_peak,
                                        model_flops_infer, model_flops_train)

META = torch.device("meta")


def batch_shapes(cfg, rows: int, seq_len: int) -> dict:
    """Meta tensors of every model input of a batch of ``rows`` x
    ``seq_len`` (the reference's ShapeDtypeStruct stand-ins)."""
    i32 = torch.int32
    out = {"tokens": torch.empty((rows, seq_len), dtype=i32, device=META),
           "labels": torch.empty((rows, seq_len), dtype=i32, device=META)}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.empty(
            (rows, cfg.num_image_tokens, cfg.vision_dim),
            dtype=torch.float32, device=META)
    if cfg.family == "encoder":
        out["frames"] = torch.empty((rows, seq_len, cfg.frontend_dim),
                                    dtype=torch.float32, device=META)
    return out


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta stand-ins for every model input of a cell (no allocation)."""
    shape = cfgreg.SHAPES[shape_name]
    return batch_shapes(cfgreg.get_config(arch), shape.global_batch,
                        shape.seq_len)


def _nbytes(tree) -> int:
    """Bytes of the tensors in a tree of dicts, lists and (named) tuples."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def state_memory_breakdown(model, tcfg, dp_total: int,
                           ranks: int | None = None) -> dict:
    """The card's persistent training state in bytes, by component, for
    the ``ranks`` of ``dp_total`` that one device holds (all of them,
    stacked, by default; 1 for one rank a process): ``params`` (one
    copy, or under fsdp those ranks' shards), ``opt_mu``/``opt_nu`` (full
    moments, those ranks' ZeRO-1 or scattered chunks, or their fsdp
    shards), ``ef_residual`` (those ranks' residuals),
    ``inflight`` (the pipelined runtime's reduced buffers: one
    replicated buffer a bucket, or those ranks' scattered chunks) and
    ``total``. Built on the meta device."""
    ranks = dp_total if ranks is None else ranks
    plan = build_plan(model, tcfg, dp_total)
    params = init_params(model.cfg, device=META)
    if tcfg.fsdp:
        params = shard_params(params, fsdp_layout_of(model, dp_total),
                              range(ranks))
    opt = init_opt(params, tcfg, plan, META, ranks)
    out = {"params": _nbytes(params),
           "opt_mu": _nbytes(opt["mu"]),
           "opt_nu": _nbytes(opt.get("nu", {})),
           "ef_residual": 0, "inflight": 0}
    if plan is not None:
        out["ef_residual"] = _nbytes(plan.init_residuals(META, ranks))
        out["inflight"] = _nbytes(plan.init_inflight(META, ranks))
    out["total"] = sum(out.values())
    return out


def _cfg_for(arch: str, shape_name: str, layers: int | None):
    """The arch's config for the shape (zamba2's long context at
    long_500k), its depth cut to ``layers`` when given: rounded down to
    whole superblocks for the hybrid and vlm families, at least one."""
    kw = {}
    if arch in ("zamba2-2.7b", "zamba2_2p7b"):
        kw["long_context"] = shape_name == "long_500k"
    cfg = cfgreg.get_config(arch, **kw)
    if layers:
        unit = {"hybrid": cfg.attn_every,
                "vlm": cfg.cross_attn_every}.get(cfg.family, 1)
        cfg = cfgreg.get_config(
            arch, **kw, num_layers=max(unit, layers // unit * unit))
    return cfg


def train_cost(model, tcfg, dp_total: int, rows_per_rank: int,
               seq_len: int, peaks=H100) -> dict:
    """What one training step of ``dp_total`` stacked ranks, each on
    ``rows_per_rank`` rows of ``seq_len``, costs one card: the counted
    microbatch, the step's totals, the state, the plan's wire bytes,
    model FLOPs, the roofline and the memory verdict. Microbatches are
    capped at the rows a rank has (the reference's cap)."""
    cfg = model.cfg
    micro = min(tcfg.microbatches, rows_per_rank)
    if rows_per_rank % micro:
        raise ValueError(f"{rows_per_rank} rows a rank do not split into "
                         f"{micro} microbatches")
    mb = rows_per_rank // micro
    batch = batch_shapes(cfg, mb, seq_len)
    counted = op_cost.microbatch_cost(model, batch)
    plain = op_cost.microbatch_cost(
        build_model(dataclasses.replace(cfg, remat=False)), batch)
    n = micro * dp_total
    plan = build_plan(model, tcfg, dp_total)
    params = init_params(cfg, device=META)
    state = state_memory_breakdown(model, tcfg, dp_total)
    wire = wire_bytes_per_step(params, tcfg.sync, dp_total,
                               plan=plan)["sparcml_bytes"]
    tokens = dp_total * rows_per_rank * seq_len
    roof = Roofline(
        flops=(counted.flops + counted.other_flops) * n,
        hbm_bytes=counted.bytes * n, coll_bytes_per_chip=wire, chips=1,
        model_flops=model_flops_train(cfg.active_param_count(), tokens),
        peak_flops=compute_peak(peaks, cfg.dtype), hbm_bw=peaks.hbm,
        link_bw=peaks.link)
    grads = dp_total * cfg.param_count() * 4 if micro > 1 else 0
    # fsdp's transient: the params gathered whole before the forward
    gathered = _nbytes(params) if tcfg.fsdp else 0
    peak = state["total"] + gathered + dp_total * counted.peak_bytes + grads
    return {
        "kind": "train", "sync_mode": tcfg.sync.mode, "dp_total": dp_total,
        "fsdp": tcfg.fsdp,
        "microbatches": micro, "rows_per_microbatch": mb, "tokens": tokens,
        "state_memory": state,
        "state_memory_per_rank": state_memory_breakdown(model, tcfg,
                                                        dp_total, ranks=1),
        "gathered_params": gathered,
        "counted": counted.as_dict(),
        "cost": {"flops": counted.flops * n,
                 "other_flops": counted.other_flops * n,
                 "bytes": counted.bytes * n, "ops": counted.ops * n},
        "remat_dup": counted.flops / plain.flops,
        "wire_bytes": wire,
        "wire_bytes_by_bucket": (plan.wire_bytes_by_bucket()
                                 if plan is not None else {}),
        "model_flops": roof.model_flops,
        "roofline": roof.as_dict(),
        "peak_estimate": peak,
        "fits": peak <= peaks.memory,
    }


def _serve_cost(model, shape, peaks=H100) -> dict:
    """A prefill of the whole batch (the encoder: its forward) or one
    decode step over full caches, counted on the meta device."""
    cfg = model.cfg
    params = init_params(cfg, device=META)
    b, s = shape.global_batch, shape.seq_len
    state = {"params": _nbytes(params), "cache": 0}
    with torch.no_grad():
        if shape.kind == "prefill":
            batch = batch_shapes(cfg, b, s)
            del batch["labels"]
            if cfg.family == "encoder":
                counted, _ = op_cost.count(model.forward, params, batch)
            else:
                counted, _ = op_cost.count(model.prefill, params, batch, s)
            tokens = b * s
        else:
            dstate = model.init_decode_state(b, s, prefix_len=s - 1,
                                             device=META)
            state["cache"] = _nbytes(dstate)
            toks = torch.empty((b, 1), dtype=torch.int32, device=META)
            counted, _ = op_cost.count(model.decode_step, params, dstate,
                                       toks)
            tokens = b
    roof = Roofline(
        flops=counted.flops + counted.other_flops,
        hbm_bytes=counted.bytes, coll_bytes_per_chip=0.0, chips=1,
        model_flops=model_flops_infer(cfg.active_param_count(), tokens),
        peak_flops=compute_peak(peaks, cfg.dtype), hbm_bw=peaks.hbm,
        link_bw=peaks.link)
    state["total"] = state["params"] + state["cache"]
    peak = state["total"] + counted.peak_bytes
    return {"kind": shape.kind, "tokens": tokens,
            "state_memory": state,
            "counted": counted.as_dict(), "cost": counted.as_dict(),
            "model_flops": roof.model_flops, "roofline": roof.as_dict(),
            "peak_estimate": peak, "fits": peak <= peaks.memory}


def run_cell(arch: str, shape_name: str, dp_total: int = 2,
             layers: int | None = None, out_dir: str | None = None,
             sync_override: str | None = None) -> dict:
    """Count one cell (see the module docstring); writes its JSON to
    ``out_dir`` when given and returns the record. ``sync_override``:
    "dense" (dense sync and fsdp) or "sparcml" (the arch's own config),
    as the reference's."""
    layout = f"stacked{dp_total}"
    rec = {"arch": arch, "shape": shape_name, "layout": layout,
           "status": "ok"}
    ok, reason = cfgreg.applicable_shapes(arch)[shape_name]
    shape = cfgreg.SHAPES[shape_name]
    if not ok:
        rec.update(status="skipped", reason=reason)
    else:
        try:
            cfg = _cfg_for(arch, shape_name, layers)
            model = build_model(cfg)
            rec.update(params=cfg.param_count(),
                       active_params=cfg.active_param_count())
            full = _cfg_for(arch, shape_name, None).num_layers
            if cfg.num_layers != full:
                rec["reduced"] = f"depth {full} -> {cfg.num_layers} layers"
            if shape.kind == "train":
                tcfg = (make_train_config(sync_mode="dense", fsdp=True)
                        if sync_override == "dense"
                        else cfgreg.get_train_config(arch))
                if shape.global_batch % dp_total:
                    raise ValueError(f"global batch {shape.global_batch} "
                                     f"does not split over {dp_total} ranks")
                rec.update(train_cost(model, tcfg, dp_total,
                                      shape.global_batch // dp_total,
                                      shape.seq_len))
            else:
                rec.update(_serve_cost(model, shape))
        except Exception as exc:             # noqa: BLE001 (one cell of many)
            rec.update(status="error", error=f"{type(exc).__name__}: {exc}",
                       trace=traceback.format_exc()[-2000:])
        finally:
            gc.collect()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"__{sync_override}" if sync_override else ""
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{layout}{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch's depth to this many layers")
    ap.add_argument("--dp", type=int, default=2,
                    help="data-parallel ranks stacked on the card")
    ap.add_argument("--sync", choices=("dense", "sparcml"), default=None,
                    help="train cells: dense sync with fsdp, or the arch's "
                         "own config (the reference's override)")
    args = ap.parse_args(argv)
    archs = ([cfgreg.EXTERNAL_NAMES[a] for a in cfgreg.ARCH_IDS]
             if (args.all or args.arch is None) else [args.arch])
    shapes = (list(cfgreg.SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    results = []
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, args.dp, args.layers, args.out, args.sync)
            tag = f"{a}__{s}__{rec['layout']}"
            if rec["status"] == "ok":
                r = rec["roofline"]
                extra = (f" dominant={r['dominant']} bound={r['bound_s']:.4g}s"
                         f" mfu_bound={r['mfu_bound']:.2%} state="
                         f"{rec['state_memory']['total']:.4g}B peak_estimate="
                         f"{rec['peak_estimate']:.4g}B fits={rec['fits']}")
            elif rec["status"] == "error":
                extra = " " + rec["error"][:160]
            else:
                extra = " " + rec.get("reason", "")
            print(f"== {tag}: {rec['status']}{extra}", flush=True)
            results.append(rec)
    n = {k: sum(r["status"] == k for r in results)
         for k in ("ok", "skipped", "error")}
    print(f"\nDRY-RUN SUMMARY: {n['ok']} ok / {n['skipped']} skipped / "
          f"{n['error']} errors of {len(results)} cells")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
