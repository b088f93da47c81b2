"""A gloo world of 2 processes (one rank each) against the same runs over
``StackedCollectives(2)`` in one process, on the CPU: the ranks agree on
their network parameters, and fsdp serving holds each process's shards.

* "auto": each process fits the network on its own ladder, rank 1's
  patched to fit another network (under which every bucket would be
  dense), and calibration gives every rank rank 0's fit. Both ranks then
  hold the same ``NetworkParams`` and the same plan, and 2 steps are
  bit-equal to the stacked ranks' on rank 0's parameters.
* "adapt": the adaptive runtime's controller over the process group
  costs plans on the agreed parameters: without the agreement rank 1's
  controller would hold its own fit and could swap to another plan than
  rank 0's (its collectives would then not match). 8 pipelined steps
  with adapt on are bit-equal to the stacked run.
* "serve": ``build_prefill`` / ``build_serve_step`` with ``fsdp=True``
  over the group: each process holds only its shards (the held bytes
  are the layout's), takes the global batch of 4 and serves its 2 rows,
  whose logits and caches after a prefill and 3 decode steps match the
  stacked fsdp run's rows at the model parity tolerance (rtol 1e-5, a
  floor of 1e-5 of the largest magnitude: a GEMM of 2 rows and one of 4
  may round differently).

One thread in every process; the world is given a time limit.
"""
import os
import socket
import tempfile

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                          StackedCollectives)
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.cost_model import NetworkParams, t_dense_allreduce
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model, init_params
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.adapt import AdaptConfig
from repro_torch.serve.engine import build_prefill, build_serve_step
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils import calibrate as cal
from repro_torch.utils.tree import tree_leaves

WORLD = 2
WORLD_TIMEOUT_S = 180
NET0 = NetworkParams(1e-6, 50e9)      # rank 0's ladder fits this
NET1 = NetworkParams(1e-3, 50e9)      # rank 1's: every bucket dense
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = DataConfig(global_batch=8, seq_len=16, vocab_size=256)
SERVE_ARCH = "llama3-405b"
SERVE_B, SERVE_S, SERVE_CACHE, SERVE_STEPS = 4, 8, 16, 3


def _tcfg(**sync):
    return TrainConfig(
        sync=SyncConfig(**{**dict(mode="sparcml", k_per_bucket=32,
                                  bucket_size=128, qsgd_bits=4,
                                  qsgd_bucket=128, min_sparse_size=1024),
                           **sync}),
        optimizer=OptimizerConfig(),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=1,
                                total_steps=10),
        microbatches=2)


def _model():
    return build_model(ModelConfig(**TINY, dtype=torch.float32,
                                   param_dtype=torch.float32))


def _ladder(net: NetworkParams, p: int = WORLD) -> list:
    """The dense-allreduce times ``net`` predicts on the CPU's ladder:
    what a measurement fitting exactly ``net`` would read."""
    return [(n * 4, t_dense_allreduce(p, n, net)) for n in cal.DEFAULT_SIZES]


# what rank 0's ladder fits: the stacked runs take the same parameters
NET0_FIT = cal.fit_network_params(*zip(*_ladder(NET0)), p=WORLD)


def _state(trainer) -> list:
    s = trainer.state
    return [*tree_leaves(s.params), *tree_leaves(s.residuals)]


def train_cases(coll) -> dict:
    """The "auto" and "adapt" cases over ``coll``."""
    out = {}
    trainer = Trainer(_model(), _tcfg(), DATA, dp_total=WORLD, device="cpu",
                      lowering="manual", coll=coll,
                      net=NET0_FIT if coll.local_ranks == WORLD else None)
    trainer.init()
    trainer.run(2)
    net = trainer._calibrated_net()
    out["auto"] = ([net.alpha, net.link_bytes_per_s],
                   trainer.plan.algorithms(), _state(trainer))

    trainer = Trainer(_model(), _tcfg(algorithm="dsar_split_allgather"),
                      DATA, dp_total=WORLD, device="cpu", lowering="manual",
                      coll=coll)
    if coll.local_ranks == WORLD:
        trainer._net_cal = NET0_FIT
    trainer.init()
    trainer.run_pipelined(8, superstep=2, depth=2,
                          adapt=AdaptConfig(window=2, patience=1))
    rt = trainer.last_adapt_runtime
    net = rt.controller.net
    out["adapt"] = ([net.alpha, net.link_bytes_per_s],
                    rt.current_plan.algorithms(), _state(trainer))
    return out


def serve_case(coll) -> dict:
    """fsdp serving of the smoke config's llama3-405b over ``coll``:
    (held bytes, the layout's bytes for the held ranks, logits, caches)."""
    cfg = configs.smoke_config(SERVE_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    layout = ts.fsdp_layout_of(model, WORLD)
    ranks = ts.held_ranks(coll, WORLD)
    held = ts.shard_params(params, layout, ranks)
    del params
    whole = init_params(cfg, device="meta")
    want = sum(
        (len(ranks) * x.numel() // lay.size * lay.shard
         if lay.dim is not None else x.numel()) * x.element_size()
        for x, lay in zip(tree_leaves(whole), tree_leaves(layout)))
    got = sum(x.numel() * x.element_size() for x in tree_leaves(held))
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=torch.Generator().manual_seed(1))
    pre = build_prefill(model, SERVE_CACHE, fsdp=True, coll=coll)
    step = build_serve_step(model, SERVE_CACHE, fsdp=True, coll=coll)
    logits, state = pre(held, {"tokens": tokens})
    seen = [logits]
    for _ in range(SERVE_STEPS):
        logits, state = step(held, state, torch.argmax(
            logits, -1, keepdim=True).to(torch.int32))
        seen.append(logits)
    return {"bytes": (got, want), "logits": torch.stack(seen),
            "k": state.kv.k.clone(), "v": state.kv.v.clone()}


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    ladder = _ladder(NET0 if rank == 0 else NET1)
    cal.measure_allreduce_times = lambda coll, sizes, repeats: ladder
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        coll = ProcessGroupCollectives(device="cpu")
        res = train_cases(coll)
        res["serve"] = serve_case(coll)
    finally:
        dist.destroy_process_group()
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
            ctx = mp.get_context("spawn")
            port = _free_port()
            procs = [ctx.Process(target=_worker, args=(r, port, d))
                     for r in range(WORLD)]
            for p in procs:
                p.start()
            stacked = StackedCollectives(WORLD, device="cpu")
            ref = train_cases(stacked)
            ref["serve"] = serve_case(stacked)
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
    return per_rank, ref


@pytest.mark.parametrize("case", ["auto", "adapt"])
def test_ranks_agree_on_the_fit_and_match_stacked(results, case):
    per_rank, ref = results
    net, plan, state = ref[case]
    assert net == [NET0_FIT.alpha, NET0_FIT.link_bytes_per_s]
    if case == "auto":
        assert "dsar_split_allgather" in plan.values()
    for r in range(WORLD):
        got_net, got_plan, got_state = per_rank[r][case]
        assert got_net == net, (case, r)
        assert got_plan == plan, (case, r)
        assert len(got_state) == len(state)
        for got, want in zip(got_state, state):
            if got.shape != want.shape:          # a rank axis: its slice
                want = want[r:r + 1]
            assert torch.equal(got, want), (case, r)


def test_fsdp_serving_each_process_holds_its_shards(results):
    per_rank, ref = results
    got, want = ref["serve"]["bytes"]
    assert got == want
    whole = ref["serve"]
    rows = SERVE_B // WORLD
    for r in range(WORLD):
        mine = per_rank[r]["serve"]
        got, want = mine["bytes"]
        assert got == want < whole["bytes"][0]
        sl = slice(r * rows, (r + 1) * rows)
        for key, cut in (("logits", (slice(None), sl)),
                         ("k", (slice(None), sl)), ("v", (slice(None), sl))):
            a, b = mine[key], whole[key][cut]
            assert a.shape == b.shape, key
            torch.testing.assert_close(
                a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
