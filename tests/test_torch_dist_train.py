"""The per-rank training step over ``torch.distributed`` (gloo, 2
processes on the CPU) against the same step over ``StackedCollectives(2)``
on one device.

One world of 2 spawned processes runs every case once, each process one
rank through ``ProcessGroupCollectives``: it computes its slice of the
global batch, gathers the loss and the guard's verdict, draws its own
QSGD bits (its slice of the stacked ranks' draw, asking for its own
words only), and starts from the same seeded params. The cases: the
SparCML step (synchronous, pipelined, through the Trainer, a guard
trip), the dense step (each rank its rows, the grads summed in rank
order), fsdp (each rank its shards, on a MoE model whose ranks share a
microbatch's capacity), a checkpoint saved, restored and continued (and
a stacked run's checkpoint, of the other ZeRO layout, restored by the
world), the own-rank bits. The tests hold each rank's results to the
stacked run's, bit for bit (one thread in every process, so the model's sums run in one
order); the stacked run goes while the world runs. Then each process
runs ``run_lm --lowering manual --pipeline``, and ``run_lm --chaos`` with
its checkpoints, as torchrun starts it (its environment variables, gloo
with ``--device cpu``): the chaos run's final state and its fault events
are the stacked chaos run's. The world is given a time limit.
"""
import dataclasses
import os
import socket
import tempfile

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                          StackedCollectives)
from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch import obs as obs_mod
from repro_torch.runtime import pipeline as rt_pipeline
from repro_torch.runtime.faults import FaultInjector, FaultPlan, RecoveryConfig
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_leaves

WORLD = 2
WORLD_TIMEOUT_S = 240
STEPS = 3
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = DataConfig(global_batch=8, seq_len=16, vocab_size=256)
CASES = ("sync", "pipelined", "trainer", "guard", "dense", "fsdp", "ckpt",
         "ckpt_from_stacked", "chaos")
BITS = ((0, 96), (3, 40))   # (bucket, a rank's words) the bits case draws
CHAOS_SEED, CHAOS_STEPS = 4, 30


def _tcfg(**kw):
    return dataclasses.replace(TrainConfig(
        sync=SyncConfig(mode="sparcml", k_per_bucket=4, bucket_size=128,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        qsgd_bucket=128, min_sparse_size=1024),
        optimizer=OptimizerConfig(),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=2,
                                total_steps=10),
        microbatches=2), **kw)


def _dense_tcfg(fsdp):
    return _tcfg(sync=SyncConfig(mode="dense"), fsdp=fsdp)


def _model(**kw):
    return build_model(ModelConfig(**{**TINY, **kw}, dtype=torch.float32,
                                   param_dtype=torch.float32))


# fsdp's case trains a MoE model whose experts drop assignments: the
# ranks share each microbatch's capacity, one exchange a layer
MOE = dict(family="moe", num_experts=4, experts_per_token=2, moe_d_ff=64,
           capacity_factor=1.0)


def _state_tensors(state, metrics_rows):
    """(replicated tensors, tensors that may hold a leading rank axis,
    metrics): the optimizer moments are ZeRO-1 chunks (zero1 is the
    default) or fsdp shards, of which one rank a process holds its own;
    fsdp's params are shards too (the whole leaves compare whole)."""
    moments = [x for k in sorted(state.opt) if k != "count"
               for x in tree_leaves(state.opt[k])]
    held = [*tree_leaves(state.params), *moments]
    for extra in (state.residuals, state.inflight):
        if extra is not None:
            held += tree_leaves(extra)
    return [state.opt["count"]], held, metrics_rows


def _trainer(model, tcfg, coll, **kw):
    return Trainer(model, tcfg, DATA, dp_total=WORLD, device="cpu",
                   lowering="manual", coll=coll, **kw)


def _one_rank(coll):
    return coll.local_ranks < coll.p


def run_cases(coll, d):
    """Every case over ``coll``: {case: (replicated tensors, per-rank
    tensors with the held ranks on a leading axis (except the in-flight
    buffers, replicated), metrics)}, and the bits case. ``d``: the
    directory both forms share (checkpoints)."""
    model, tcfg = _model(), _tcfg()
    out = {}

    step, plan = ts.build_train_step(model, tcfg, WORLD, "cpu",
                                     lowering="manual", coll=coll)
    state = ts.init_state(model, tcfg, plan, "cpu", coll=coll)
    losses = []
    for i in range(STEPS):
        state, m = step(state, synthetic_batch(DATA, i))
        losses.append(m["loss"])
    out["sync"] = _state_tensors(state, losses)

    step, plan = rt_pipeline.build_pipelined_step(
        model, tcfg, WORLD, "cpu", guard=True, lowering="manual", coll=coll)
    state = rt_pipeline.attach_inflight(
        ts.init_state(model, tcfg, plan, "cpu", coll=coll), plan)
    rows = []
    for i in range(STEPS):
        state, m = step(state, synthetic_batch(DATA, i))
        rows += [m["loss"], m["nonfinite"],
                 *[m["telemetry"][n] for n in sorted(m["telemetry"])]]
    out["pipelined"] = _state_tensors(state, rows)

    trainer = Trainer(model, tcfg, DATA, dp_total=WORLD, device="cpu",
                      lowering="manual", coll=coll)
    trainer.init()
    trainer.run(2)
    trainer.run_pipelined(2 + STEPS, superstep=2)
    out["trainer"] = _state_tensors(
        trainer.state, [torch.tensor(trainer.log.losses)])

    # a NaN in rank 1's grads at the second step trips the guard on every
    # rank: no rank applies, every rank's state stays
    orig = ts.rank_grads
    calls = {"n": 0}
    mine = (list(range(WORLD)) if coll.local_ranks == WORLD
            else [coll.rank])
    hit = torch.tensor([float("nan") if r == 1 else 0.0 for r in mine])

    def poisoned(model_, params, batch, held, n_micro):
        loss, leaves = orig(model_, params, batch, held, n_micro)
        if calls["n"] == 1:
            leaves = [leaves[0] + hit.reshape((held,) + (1,) *
                                              (leaves[0].dim() - 1)),
                      *leaves[1:]]
        calls["n"] += 1
        return loss, leaves

    ts.rank_grads = poisoned
    try:
        step, plan = rt_pipeline.build_pipelined_step(
            model, tcfg, WORLD, "cpu", guard=True, lowering="manual",
            coll=coll, telemetry=False)
        state = rt_pipeline.attach_inflight(
            ts.init_state(model, tcfg, plan, "cpu", coll=coll), plan)
        flags = []
        for i in range(STEPS):
            state, m = step(state, synthetic_batch(DATA, i))
            flags.append(m["nonfinite"])
    finally:
        ts.rank_grads = orig
    out["guard"] = _state_tensors(state, flags)

    # the dense step per rank and fsdp: each rank its rows, the grads
    # summed in rank order (fsdp: reduce-scattered onto its shards, on a
    # MoE model whose ranks share capacity)
    for case, m in (("dense", model), ("fsdp", _model(**MOE))):
        dcfg = _dense_tcfg(fsdp=case == "fsdp")
        step, _ = ts.build_train_step(m, dcfg, WORLD, "cpu",
                                      lowering="manual", coll=coll)
        state = ts.init_state(m, dcfg, None, "cpu", coll=coll,
                              dp_total=WORLD)
        losses = []
        for i in range(STEPS):
            state, m = step(state, synthetic_batch(DATA, i))
            losses += [m["loss"], m["grad_norm"]]
        out[case] = _state_tensors(state, losses)

    # a checkpoint at step 2, a fresh Trainer resumed from it and run on
    # to 4; the world also resumes the stacked run's step-2 checkpoint
    # (scattered, converted to ZeRO-1)
    tag = "world" if _one_rank(coll) else "stacked"
    run = _trainer(model, tcfg, coll, ckpt_dir=os.path.join(d, tag))
    run.init()
    run.run(2)
    resumed = _trainer(model, tcfg, coll, ckpt_dir=os.path.join(d, tag))
    assert resumed.init_or_resume() == 2
    resumed.run(4)
    out["ckpt"] = _state_tensors(resumed.state,
                                 [torch.tensor(resumed.log.losses)])
    if _one_rank(coll):
        other = _trainer(model, tcfg, coll,
                         ckpt_dir=os.path.join(d, "seed_stacked"))
        assert other.init_or_resume() == 2
        other.run(4)
        out["ckpt_from_stacked"] = _state_tensors(
            other.state, [torch.tensor(other.log.losses)])
    else:
        out["ckpt_from_stacked"] = out["ckpt"]

    # own-rank bits: rank r asks for its n words only, the stacked draw
    # for every rank's (rank-major)
    rand = ts.StepBits(0, 1, "cpu", WORLD)
    asked, draw = [], ts.random_bits
    ts.random_bits = lambda n, *a, **k: (asked.append(n), draw(n, *a, **k))[1]
    try:
        mine = ts.rank_rand_fn(rand, coll)
        bits = [mine(b, n if _one_rank(coll) else WORLD * n) for b, n in BITS]
    finally:
        ts.random_bits = draw
    out["bits"] = (bits, asked)
    return out


def seed_stacked_checkpoint(d):
    """The stacked run's checkpoint at step 2, for the world to resume:
    in the scattered layout (the stacked sum, where scattered trains
    bit-equal to ZeRO-1), so the world's resume also converts the
    layout, every rank's chunks, and keeps its own."""
    tcfg = _tcfg()
    tcfg = dataclasses.replace(tcfg, sync=dataclasses.replace(
        tcfg.sync, output_mode="scattered"))
    trainer = Trainer(_model(), tcfg, DATA, dp_total=WORLD, device="cpu",
                      ckpt_dir=os.path.join(d, "seed_stacked"))
    trainer.init()
    trainer.run(2)


def chaos_stacked(d):
    """run_lm --chaos's run over the stacked ranks at the world's size:
    (final state tensors, the fault events, the losses)."""
    from repro_torch.train import run_lm

    obs = obs_mod.configure(metrics=True, set_as_default=False)
    trainer = _trainer(_model(), run_lm.train_config(CHAOS_STEPS), None,
                       ckpt_dir=os.path.join(d, "chaos_stacked"),
                       ckpt_every=10, obs=obs)
    trainer.init_or_resume()
    trainer.run_pipelined(
        CHAOS_STEPS, staleness=1, superstep=2, depth=2,
        injector=FaultInjector(FaultPlan.chaos(CHAOS_SEED, CHAOS_STEPS,
                                               ckpt_every=10)),
        recovery=RecoveryConfig(backoff_base_s=0.01, backoff_max_s=0.1))
    return _chaos_record(trainer)


def _chaos_record(trainer):
    reg = trainer.obs.metrics
    events = [(e["fault"], e["step"]) for e in reg.events_named(
        "faults/injected")]
    return (_state_tensors(trainer.state, [torch.tensor(trainer.log.losses)]),
            events, trainer.log.restarts)


RUN_LM_STEPS = 10          # 8 synchronous probe steps, then 2 pipelined
RUN_LM_ARGS = ["--fast", "--steps", str(RUN_LM_STEPS), "--pipeline",
               "--superstep", "2", "--lowering", "manual", "--device", "cpu"]
CHAOS_ARGS = ["--fast", "--steps", str(CHAOS_STEPS), "--chaos",
              str(CHAOS_SEED), "--superstep", "2", "--lowering", "manual",
              "--device", "cpu"]


def _tiny_lm_config(fast):
    return (ModelConfig(**TINY, dtype=torch.float32,
                        param_dtype=torch.float32), DATA)


def _worker(rank, ports, out_dir):
    from repro_torch.train import run_lm

    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{ports[0]}",
                            world_size=WORLD, rank=rank)
    try:
        res = run_cases(ProcessGroupCollectives(device="cpu"), out_dir)
    finally:
        dist.destroy_process_group()
    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(ports[1]))
    run_lm.lm_config = _tiny_lm_config
    res["run_lm"] = torch.tensor(run_lm.main(RUN_LM_ARGS).losses)
    # run_lm --chaos: its Trainer kept to read the final state and events
    kept = {}
    pipelined = Trainer.run_pipelined

    def keep(self, *a, **k):
        kept["trainer"] = self
        return pipelined(self, *a, **k)

    Trainer.run_pipelined = keep
    os.environ["MASTER_PORT"] = str(ports[2])
    run_lm.main(CHAOS_ARGS)
    res["chaos"] = _chaos_record(kept["trainer"])
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        try:
            seed_stacked_checkpoint(d)
            ctx = mp.get_context("spawn")
            ports = (_free_port(), _free_port(), _free_port())
            procs = [ctx.Process(target=_worker, args=(r, ports, d))
                     for r in range(WORLD)]
            for p in procs:
                p.start()
            # the stacked run meanwhile, in this process
            stacked = run_cases(StackedCollectives(WORLD, device="cpu"), d)
            from repro_torch.train import run_lm
            trainer = Trainer(_model(), run_lm.train_config(RUN_LM_STEPS),
                              DATA, dp_total=WORLD, device="cpu",
                              lowering="manual")
            trainer.init()
            trainer.run(8)
            trainer.run_pipelined(RUN_LM_STEPS, superstep=2, depth=2)
            stacked["run_lm"] = torch.tensor(trainer.log.losses)
            stacked["chaos"] = chaos_stacked(d)
        finally:
            torch.set_num_threads(threads)
        for p in procs:
            p.join(WORLD_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        if alive or any(p.exitcode for p in procs):
            pytest.fail(f"gloo world failed: exit codes "
                        f"{[p.exitcode for p in procs]}, "
                        f"{len(alive)} killed at the time limit")
        per_rank = [torch.load(os.path.join(d, f"rank{r}.pt"))
                    for r in range(WORLD)]
        # the world's newest checkpoint (step 4) in the stacked Trainer
        restored = Trainer(_model(), _tcfg(), DATA, dp_total=WORLD,
                           device="cpu", lowering="manual",
                           ckpt_dir=os.path.join(d, "world"))
        assert restored.init_or_resume() == 4
        stacked["restored_world"] = _state_tensors(restored.state, [])
    return per_rank, stacked


def _held_equal(got_held, held, r, case):
    assert len(got_held) == len(held)
    for got, want in zip(got_held, held):
        if got.shape == want.shape:              # replicated
            assert torch.equal(got, want), (case, r)
        else:                    # a leading rank axis: rank r's slice
            assert got.shape[0] == 1 and want.shape[0] == WORLD
            assert torch.equal(got[0], want[r]), (case, r)


@pytest.mark.parametrize("case", CASES)
def test_process_group_step_bit_equal_to_stacked(results, case):
    per_rank, stacked = results
    (shared, held, metrics) = (stacked[case][0] if case == "chaos"
                               else stacked[case])
    for r in range(WORLD):
        got_shared, got_held, got_metrics = (per_rank[r][case][0]
                                             if case == "chaos"
                                             else per_rank[r][case])
        assert len(got_shared) == len(shared)
        for got, want in zip(got_shared, shared):
            assert torch.equal(got, want), (case, r)
        _held_equal(got_held, held, r, case)
        assert len(got_metrics) == len(metrics)
        for got, want in zip(got_metrics, metrics):
            assert torch.equal(got, want), (case, r)
    if case == "guard":
        assert [float(f) for f in metrics] == [0.0, 1.0, 0.0]
    if case == "fsdp":                           # the params are shards
        assert held[0].shape[0] == WORLD


def test_chaos_run_names_the_planned_faults(results):
    """run_lm --chaos in the world: every process injects the plan's
    faults at its steps (one twice: its batch was refunded by a rewind
    and made again) and restarts as often as the stacked chaos run."""
    per_rank, stacked = results
    _, events, restarts = stacked["chaos"]
    plan = FaultPlan.chaos(CHAOS_SEED, CHAOS_STEPS, ckpt_every=10)
    assert set(events) == {(s.kind, s.step) for s in plan.specs}
    assert restarts >= 2
    for r in range(WORLD):
        assert per_rank[r]["chaos"][1:] == (events, restarts), r


def test_world_checkpoint_restores_in_stacked_trainer(results):
    """The world's newest checkpoint restored by the stacked Trainer is
    the stacked run's state at that step, bit for bit."""
    _, stacked = results
    shared, held, _ = stacked["ckpt"]
    got_shared, got_held, _ = stacked["restored_world"]
    for got, want in zip(got_shared + got_held, shared + held):
        assert torch.equal(got, want)


def test_each_rank_draws_only_its_own_bits(results):
    """Rank r's default QSGD bits are slice r of the stacked draw (one
    draw of n words a rank, in rank order), and it asks the generator
    for its own n words, not n * p."""
    per_rank, stacked = results
    want, asked = stacked["bits"]
    assert asked == [n for _, n in BITS for _ in range(WORLD)]
    for r in range(WORLD):
        got, got_asked = per_rank[r]["bits"]
        assert got_asked == [n for _, n in BITS]
        for g, w, (_, n) in zip(got, want, BITS):
            assert torch.equal(g, w[r * n:(r + 1) * n]), r


def test_run_lm_under_torchrun_matches_stacked(results):
    """Every process's losses of run_lm's per-rank loop (probe and
    pipelined steps) are the stacked Trainer's, bit for bit."""
    per_rank, stacked = results
    assert stacked["run_lm"].shape == (RUN_LM_STEPS,)
    for r in range(WORLD):
        assert torch.equal(per_rank[r]["run_lm"], stacked["run_lm"]), r
