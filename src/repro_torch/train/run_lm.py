"""Train the LM with SparCML gradient sync (DSAR + 4-bit QSGD) on one GPU.

    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 20
    PYTHONPATH=src python -m repro_torch.train.run_lm --fast
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 40 --pipeline
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 20 --lowering manual
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 40 --pipeline --lowering manual
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 40 --pipeline \
        --adapt --trace t.json --metrics-out m.jsonl --blackbox bb.json
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.train.run_lm \
        --steps 20 --lowering manual
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 40 --zero
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 20 --fsdp
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 30 --chaos 4
    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 20 --algorithm auto
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.train.run_lm \
        --steps 30 --chaos 4 --lowering manual

The PyTorch counterpart of ``examples/train_lm_topk.py``: lm-100m (12
layers, d=768, GQA 12/4 heads, SwiGLU 2048, vocab 32768, f32) at global
batch 32 x 512 in 2 microbatches, 4 data-parallel replicas stacked on one
device, k = 8 of every 512, DSAR split-allgather, 4-bit QSGD. ``--fast``
is the example's lm-12m.

``--pipeline`` drives the non-blocking runtime instead of the
synchronous ``Trainer.run``: one-step-stale pipelined supersteps of
``--superstep`` steps, dispatched two deep with background data
prefetch, the reduce half on a side CUDA stream. A short synchronous
probe runs first so the overlap win can be printed. ``--ckpt-dir``
checkpoints every 25 steps and resumes from the newest checkpoint there
(the example's default directory lies outside the checkout, so here
there is none unless asked for). ``--lowering manual`` syncs through the
per-rank executor (the wire protocols over the stacked ranks) instead of
the stacked sum, in both loops. Under ``torchrun`` (its ``RANK`` and
``WORLD_SIZE`` variables, a world of 1 included) every process holds one
rank of a ``torch.distributed`` group (NCCL on the card, each process on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``), the data-parallel
width is the world size, and only
``--lowering manual`` runs; its checkpoints are the stacked run's (rank
0 writes them), and ``--chaos`` runs there too: every process builds
the same fault plan and rewinds to the same verified checkpoint, and
with ``--blackbox PATH`` rank 0 writes PATH, any other rank PATH.rank<r>
when it dies. The optimizer moments are ZeRO-1 chunks, as the example's
(``zero1=True``): over torch.distributed each process holds its 1/p of
them.

``--algorithm`` names the buckets' sparse allreduce (the example's
DSAR split-allgather by default); ``auto`` selects each bucket's by the
cost model on network parameters the Trainer fits first on the run's own
context (the stacked ranks: the device's sum over the rank axis, which
moves no byte between ranks; under torchrun the process group, every
rank taking rank 0's fit), and prints them and each bucket's algorithm.

``--fsdp`` trains with dense sync and ZeRO-3 (``TrainConfig.fsdp``): the
params and moments live as each rank's shards, gathered whole for the
forward, the grads reduce-scattered (synchronous loop only); it prints
the state by component first, as ``--zero`` does.

``--zero`` is the example's ZeRO-sharded state: the scattered output
mode, where the gradient exchange stops at the owner shard, the update
runs on the shard and the parameters come back by one allgather a
bucket; the run first prints the device's state by component
(``launch.dryrun.state_memory_breakdown``: the four stacked ranks'
moment chunks and EF residuals, or one rank's under torchrun). ``--chaos
SEED`` is the example's recovery smoke: a seed-derived
``FaultPlan.chaos`` of recoverable faults (grad NaN/Inf, straggler, data
stall, collective raise, a corrupted checkpoint and the restore that
must fall back) against the pipelined runtime (implied) under the retry
supervisor, with checkpoints every 10 steps (in ``--ckpt-dir``, or a
temporary directory removed at the end); the run must complete, prints
its closing "chaos recovery: survived ..." line, and exits non-zero when
the plan injected nothing.

Observability, as the example has it: ``--adapt`` (with ``--pipeline``)
re-selects bucket algorithms from measured densities on network
parameters calibrated on the run's own context; ``--trace`` exports a
Chrome-trace JSON (host spans; the synchronous loop's step records its
phases as ``sparcml.*`` spans) on Unix time in microseconds, which lines
up with a ``torch.profiler`` export of the same process;
``--metrics-out`` writes the metrics JSONL and runs a drift audit of the
final plan; ``--blackbox`` attaches the flight recorder. At the end the
run prints its plan swaps, the drift audit, the health summary, the
metrics summary and the paths it wrote.
"""
from __future__ import annotations

import argparse
import os
import shutil
import statistics
import tempfile

import torch
import torch.distributed as dist

from repro_torch import obs as obs_mod
from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                          StackedCollectives)
from repro_torch.comm.plan import SPARSE_ALGORITHMS

from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.dryrun import state_memory_breakdown
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.faults import FaultInjector, FaultPlan, RecoveryConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils.calibrate import DegenerateFit

DP = 4
CKPT_EVERY = 25


def lm_config(fast: bool) -> tuple[ModelConfig, DataConfig]:
    if fast:
        cfg = ModelConfig(name="lm-12m", family="dense", num_layers=4,
                          d_model=256, num_heads=8, num_kv_heads=4, d_ff=512,
                          vocab_size=2048, dtype=torch.float32,
                          param_dtype=torch.float32, max_seq_len=256)
        return cfg, DataConfig(global_batch=16, seq_len=128, vocab_size=2048)
    cfg = ModelConfig(name="lm-100m", family="dense", num_layers=12,
                      d_model=768, num_heads=12, num_kv_heads=4, d_ff=2048,
                      vocab_size=32768, dtype=torch.float32,
                      param_dtype=torch.float32, max_seq_len=1024)
    return cfg, DataConfig(global_batch=32, seq_len=512, vocab_size=32768)


def train_config(steps: int, mode: str = "sparcml",
                 zero: bool = False, fsdp: bool = False,
                 algorithm: str = "dsar_split_allgather") -> TrainConfig:
    """The example's config; ``zero`` its --zero (the scattered output
    mode), ``fsdp`` dense sync with ZeRO-3, ``algorithm`` the buckets'
    (``auto``: the cost model's). ZeRO-1 is on, as the example's."""
    if fsdp:
        mode = "dense"
    return TrainConfig(
        sync=SyncConfig(mode=mode, k_per_bucket=8, bucket_size=512,
                        algorithm=algorithm, qsgd_bits=4,
                        min_sparse_size=65536,
                        output_mode="scattered" if zero else "replicated"),
        optimizer=OptimizerConfig(kind="adamw"),
        schedule=ScheduleConfig(kind="wsd", peak_lr=6e-4, warmup_steps=20,
                                total_steps=steps),
        microbatches=2,
        fsdp=fsdp,
        zero1=True,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--pipeline", action="store_true",
                    help="non-blocking runtime: pipelined stale-gradient "
                         "supersteps + async driver")
    ap.add_argument("--superstep", type=int, default=4,
                    help="steps per superstep (with --pipeline)")
    ap.add_argument("--lowering", choices=("spmd", "manual"), default="spmd",
                    help="sparcml executor: the stacked sum or the per-rank "
                         "wire protocols")
    ap.add_argument("--algorithm", choices=("auto",) + SPARSE_ALGORITHMS,
                    default="dsar_split_allgather",
                    help="the buckets' sparse allreduce; auto selects each "
                         "bucket's by the cost model on network parameters "
                         "fitted on the run's context")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card (default) or the CPU's plain versions")
    ap.add_argument("--adapt", action="store_true",
                    help="closed-loop re-planning: measured per-bucket "
                         "densities + calibrated alpha-beta model re-select "
                         "collective algorithms at drain barriers (with "
                         "--pipeline)")
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="export a Chrome-trace JSON of the run (host "
                         "spans; the synchronous step's sparcml.* phases)")
    ap.add_argument("--metrics-out", type=str, default=None, metavar="PATH",
                    help="write the metrics/event JSONL (per-bucket "
                         "nnz/wire histograms, plan swaps, step times) and "
                         "run a cost-model drift audit at the end")
    ap.add_argument("--blackbox", type=str, default=None, metavar="PATH",
                    help="attach the flight recorder: a bounded ring of "
                         "driver retires dumped to this path on exception, "
                         "watchdog fire, or SIGTERM/SIGINT")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-sharded training state: the gradient exchange "
                         "stops at the owner shard (scattered output mode, "
                         "no allgather) and the optimizer moments live on the "
                         "owned chunks; checkpoints interoperate with "
                         "replicated runs")
    ap.add_argument("--fsdp", action="store_true",
                    help="dense sync with ZeRO-3: params and optimizer "
                         "moments sharded over the ranks, gathered for the "
                         "forward (synchronous loop)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="chaos-injection smoke: run a seed-derived FaultPlan "
                         "of recoverable faults (grad NaN/Inf, straggler, "
                         "data stall, collective raise, checkpoint "
                         "corruption) against the pipelined runtime; the run "
                         "must complete via the guarded step + retry/backoff "
                         "recovery (implies --pipeline)")
    return ap


def init_distributed(device: str):
    """Under torchrun's variables (RANK and WORLD_SIZE; a world of 1
    too): join the process group (NCCL on the card, gloo on the CPU) and
    return (this process's device, its ``ProcessGroupCollectives``);
    otherwise (device, None)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device, None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device != "cpu" else "gloo",
                            init_method="env://", world_size=world, rank=rank)
    return device, ProcessGroupCollectives(device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)

    device, coll = init_distributed(args.device)
    if coll is not None and args.lowering != "manual":
        raise SystemExit("a torch.distributed run needs --lowering manual")
    try:
        return _train(args, device, coll)
    finally:
        if coll is not None:
            dist.destroy_process_group()


def _train(args, device, coll):
    chaos = args.chaos is not None
    if chaos:
        args.pipeline = True    # the guard and the hooks live in the driver
    if args.fsdp and (args.pipeline or args.zero or args.adapt):
        raise SystemExit("--fsdp trains with dense sync: the synchronous "
                         "loop only (no --pipeline, --chaos, --zero or "
                         "--adapt)")
    root = coll is None or coll.rank == 0
    ckpt_dir, tmp_ckpt = args.ckpt_dir, None
    if chaos and not ckpt_dir:
        # one directory for every process: rank 0 makes it and says where
        made = [tempfile.mkdtemp(prefix="run_lm_chaos_") if root else None]
        if coll is not None:
            dist.broadcast_object_list(made, src=0)
        ckpt_dir = made[0]
        tmp_ckpt = ckpt_dir if root else None
    try:
        log = _run(args, device, coll, chaos, ckpt_dir)
        ckpt.barrier(coll)      # no process still reads the directory
        return log
    finally:
        if tmp_ckpt is not None:
            shutil.rmtree(tmp_ckpt, ignore_errors=True)


def _run(args, device, coll, chaos, ckpt_dir):
    say = print if coll is None or coll.rank == 0 else (lambda *a: None)
    other_rank = coll is not None and coll.rank > 0
    blackbox = args.blackbox or False
    if blackbox and other_rank:
        blackbox = f"{blackbox}.rank{coll.rank}"
    obs = obs_mod.configure(trace=bool(args.trace),
                            metrics=bool(args.metrics_out) or bool(args.trace)
                            or chaos,
                            audit=bool(args.metrics_out),
                            recorder=blackbox, set_as_default=False)
    if obs.recorder is not None:
        # rank 0 records the run; another rank writes only when it dies
        obs.recorder.deaths_only = other_rank
        obs.recorder.install_signal_handlers()
    try:
        return _run_recorded(args, device, coll, chaos, ckpt_dir, say, obs)
    except BaseException as e:
        if obs.recorder is not None:
            obs.recorder._safe_dump(f"death:{type(e).__name__}")
        raise


def _run_recorded(args, device, coll, chaos, ckpt_dir, say, obs):
    cfg, data = lm_config(args.fast)
    steps = min(args.steps, 60) if args.fast else args.steps
    model = build_model(cfg)
    say(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params")
    # a shorter checkpoint cadence under chaos: the corrupt-then-restore
    # pair needs steps > 2 * ckpt_every
    ckpt_every = 10 if chaos else CKPT_EVERY
    tcfg = train_config(steps, zero=args.zero, fsdp=args.fsdp,
                        algorithm=args.algorithm)
    dp_total = coll.p if coll is not None else DP
    if args.zero or args.fsdp:
        mem = state_memory_breakdown(
            model, tcfg, dp_total,
            ranks=coll.local_ranks if coll is not None else None)
        say(f"{'fsdp' if args.fsdp else 'zero'}: per-device state "
            + ", ".join(f"{k}={v / 1e6:.1f}MB" for k, v in mem.items()))
    trainer = Trainer(model, tcfg, data, dp_total=dp_total,
                      device=device, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, lowering=args.lowering,
                      coll=coll, obs=obs)
    if trainer.plan is not None:
        if args.algorithm == "auto":
            net = trainer._calibrated_net()
            on = "the process group" if coll is not None else "stacked ranks"
            say(f"auto: alpha {net.alpha:.4g} s, {net.link_bytes_per_s:.4g} "
                f"B/s (fitted on {on}); bucket algorithms "
                f"{trainer.plan.algorithms()}")
        say(trainer.plan.describe())
    start = trainer.init_or_resume()
    say(f"starting at step {start} (resume={'yes' if start else 'no'})")
    injector = recovery = None
    if chaos:
        plan = FaultPlan.chaos(args.chaos, steps, ckpt_every=ckpt_every)
        injector = FaultInjector(plan)
        recovery = RecoveryConfig(backoff_base_s=0.01, backoff_max_s=0.1)
        say(f"chaos plan (seed {args.chaos}): "
            + ", ".join(f"{s.kind}@{s.step}" for s in plan.specs))
    if args.pipeline:
        # short synchronous probe first, so the overlap win is measurable
        # (not under chaos: the probe loop has no recovery hooks)
        probe_to = start if chaos else min(start + 8, steps)
        if probe_to > start:
            trainer.run(probe_to)
        n_sync = len(trainer.log.step_times)
        # drop the probe's first step (warm-up); keep every pipelined step,
        # warm-up included, so the printed win is conservative
        sync_times = trainer.log.step_times[1:n_sync]
        log = trainer.run_pipelined(steps, staleness=1,
                                    superstep=args.superstep, depth=2,
                                    adapt=args.adapt, injector=injector,
                                    recovery=recovery)
        pipe_times = log.step_times[n_sync:]
        if sync_times and pipe_times:
            sync_avg = sum(sync_times) / len(sync_times)
            pipe_avg = sum(pipe_times) / len(pipe_times)
            say(f"overlap win: sync {sync_avg*1e3:.0f} ms/step -> "
                f"pipelined {pipe_avg*1e3:.0f} ms/step "
                f"({sync_avg/pipe_avg:.2f}x, staleness=1, "
                f"superstep={args.superstep}, depth=2)")
        if args.adapt:
            say(f"adaptive re-planning: {len(log.plan_swaps)} plan "
                f"swap(s)" + "".join(f"\n  step {s}: {sig.split(',')[0]}..."
                                     for s, sig in log.plan_swaps))
    else:
        log = trainer.run(steps)
    say(f"done: step {steps}, loss {log.losses[0]:.3f} -> "
        f"{log.losses[-1]:.3f}, median step "
        f"{statistics.median(log.step_times) * 1e3:.1f} ms, "
        f"restarts={log.restarts}, stragglers={len(log.straggler_events)}")
    if chaos:
        counters = {n: c.value for n, c in sorted(obs.metrics.metrics.items())
                    if getattr(c, "kind", None) == "counter"
                    and n.startswith(("faults/", "recovery/", "guard/"))}
        say("chaos recovery: survived "
            f"{injector.fired_total} injected fault(s), "
            f"restarts={log.restarts}; "
            + " ".join(f"{n}={v}" for n, v in counters.items()))
        if injector.fired_total == 0:
            raise SystemExit("chaos: the plan injected nothing (seed and "
                             "step range do not meet): the smoke proved "
                             "nothing")
    if obs.enabled:
        _report(args, trainer, obs, say)
    return log


def _report(args, trainer, obs, say) -> None:
    """The example's end of run: the drift audit of the plan the run ended
    on, the health verdicts, the metrics summary, the exported paths.
    The audit predicts on the calibrated network; where the ladder's fit
    degenerates (host timing noise) it is skipped, and says so, while the
    rest of the report and the exports go on."""
    plan = trainer.last_plan
    if obs.audit is not None and plan is not None:
        coll = (trainer.coll if trainer.coll is not None
                else StackedCollectives(trainer.dp_total, trainer.device))
        try:
            net = trainer._calibrated_net()
        except DegenerateFit as e:
            say(f"drift audit skipped: {e}")
            obs.metrics.event("audit/skipped", reason=str(e))
        else:
            obs_mod.audit_sync_plan(plan, coll, net=net, auditor=obs.audit,
                                    registry=obs.metrics)
            say(obs.audit.summary())
    if obs.metrics_on:
        mon = trainer.last_health or obs_mod.HealthMonitor(
            obs.metrics, audit=obs.audit)
        mon.evaluate()
        say("health:", mon.summary())
    written = obs.export(trace_path=args.trace,
                         metrics_path=args.metrics_out)
    if obs.metrics_on:
        say(obs.metrics.summary())
    for p in written.values():
        say(f"obs: wrote {p}")


if __name__ == "__main__":
    main()
