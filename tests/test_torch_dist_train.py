"""The per-rank training step over ``torch.distributed`` (gloo, 2
processes on the CPU) against the same step over ``StackedCollectives(2)``
on one device.

One world of 2 spawned processes runs every case once, each process one
rank through ``ProcessGroupCollectives``: it computes its slice of the
global batch, gathers the loss and the guard's verdict, draws its slice
of the stacked ranks' QSGD bits, and starts from the same seeded params.
The tests hold each rank's results to the stacked run's, bit for bit
(one thread in every process, so the model's sums run in one order).
Then each process runs ``run_lm --lowering manual --pipeline`` as
torchrun starts it (its environment variables, gloo with ``--device
cpu``). The world is given a time limit.
"""
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
from repro_torch.runtime import pipeline as rt_pipeline
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
CASES = ("sync", "pipelined", "trainer", "guard")


def _tcfg():
    return TrainConfig(
        sync=SyncConfig(mode="sparcml", k_per_bucket=4, bucket_size=128,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        qsgd_bucket=128, min_sparse_size=1024),
        optimizer=OptimizerConfig(),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=2,
                                total_steps=10),
        microbatches=2)


def _model():
    return build_model(ModelConfig(**TINY, dtype=torch.float32,
                                   param_dtype=torch.float32))


def _state_tensors(state, metrics_rows):
    """(replicated tensors, tensors that may hold a leading rank axis,
    metrics): the optimizer moments are ZeRO-1 chunks (zero1 is the
    default), of which one rank a process holds its own."""
    moments = [x for k in sorted(state.opt) if k != "count"
               for x in tree_leaves(state.opt[k])]
    return ([*tree_leaves(state.params), state.opt["count"]],
            [*moments, *tree_leaves(state.residuals)]
            + ([] if state.inflight is None else tree_leaves(state.inflight)),
            metrics_rows)


def run_cases(coll):
    """Every case over ``coll``: {case: (replicated tensors, per-rank
    tensors with the held ranks on a leading axis (except the in-flight
    buffers, replicated), metrics)}."""
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
    return out


RUN_LM_STEPS = 10          # 8 synchronous probe steps, then 2 pipelined
RUN_LM_ARGS = ["--fast", "--steps", str(RUN_LM_STEPS), "--pipeline",
               "--superstep", "2", "--lowering", "manual", "--device", "cpu"]


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
        res = run_cases(ProcessGroupCollectives(device="cpu"))
    finally:
        dist.destroy_process_group()
    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(ports[1]))
    run_lm.lm_config = _tiny_lm_config
    res["run_lm"] = torch.tensor(run_lm.main(RUN_LM_ARGS).losses)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        ports = (_free_port(), _free_port())
        procs = [ctx.Process(target=_worker, args=(r, ports, d))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
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
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stacked = run_cases(StackedCollectives(WORLD, device="cpu"))
        from repro_torch.train import run_lm
        trainer = Trainer(_model(), run_lm.train_config(RUN_LM_STEPS), DATA,
                          dp_total=WORLD, device="cpu", lowering="manual")
        trainer.init()
        trainer.run(8)
        trainer.run_pipelined(RUN_LM_STEPS, superstep=2, depth=2)
        stacked["run_lm"] = torch.tensor(trainer.log.losses)
    finally:
        torch.set_num_threads(threads)
    return per_rank, stacked


@pytest.mark.parametrize("case", CASES)
def test_process_group_step_bit_equal_to_stacked(results, case):
    per_rank, stacked = results
    shared, held, metrics = stacked[case]
    for r in range(WORLD):
        got_shared, got_held, got_metrics = per_rank[r][case]
        assert len(got_shared) == len(shared)
        for got, want in zip(got_shared, shared):
            assert torch.equal(got, want), (case, r)
        assert len(got_held) == len(held)
        for got, want in zip(got_held, held):
            if got.shape == want.shape:          # in-flight: replicated
                assert torch.equal(got, want), (case, r)
            else:                        # moments, residuals: rank r's slice
                assert got.shape[0] == 1 and want.shape[0] == WORLD
                assert torch.equal(got[0], want[r]), (case, r)
        for got, want in zip(got_metrics, metrics):
            assert torch.equal(got, want), (case, r)
    if case == "guard":
        assert [float(f) for f in metrics] == [0.0, 1.0, 0.0]


def test_run_lm_under_torchrun_matches_stacked(results):
    """Every process's losses of run_lm's per-rank loop (probe and
    pipelined steps) are the stacked Trainer's, bit for bit."""
    per_rank, stacked = results
    assert stacked["run_lm"].shape == (RUN_LM_STEPS,)
    for r in range(WORLD):
        assert torch.equal(per_rank[r]["run_lm"], stacked["run_lm"]), r
