"""The per-rank code over ``torch.distributed`` (gloo, 4 processes on the
CPU) against the same code over ``StackedCollectives(4)`` on one device.

One world of 4 spawned processes runs every case once (each process holds
one rank through ``ProcessGroupCollectives``) and saves its results; the
tests hold each against the stacked run, bit for bit: the algorithms talk
to other ranks only through the context, both contexts move the same
bytes, and both sum over ranks in rank order. The world size stays at 4
(the test host may have 2 cores), and the world is given a time limit.
"""
import os
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.comm import executor
from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                          StackedCollectives)
from repro_torch.comm.plan import build_sync_plan
from repro_torch.core import allreduce as ar
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.qsgd import QSGDConfig

WORLD = 4
WORLD_TIMEOUT_S = 240
N, K, B = 4096, 8, 256
ALGOS = ("ssar_recursive_double", "ssar_split_allgather",
         "dsar_split_allgather", "ssar_balanced_split", "ssar_rearranged_rs",
         "dense")
CASES = ALGOS + ("dsar_qsgd4",)
EXEC = ("exec_dsar_qsgd4", "exec_split_allgather", "exec_rearranged")


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((WORLD, N)).astype(np.float32)
    x[:, ::3] = np.round(x[:, ::3])                  # magnitude ties
    rand = rng.integers(-2**31, 2**31, size=(WORLD, N), dtype=np.int64)
    return torch.from_numpy(x), torch.from_numpy(rand.astype(np.int32)).view(
        torch.uint32)


def _plan(algorithm):
    meta = {"a": torch.empty((600,), device="meta"),
            "w": torch.empty((64, 256), device="meta")}
    specs = {"a": (None,), "w": ("model", None)}
    cfg = SyncConfig(mode="sparcml", k_per_bucket=4, bucket_size=128,
                     algorithm=algorithm, qsgd_bits=4, qsgd_bucket=128,
                     min_sparse_size=256)
    return build_sync_plan(meta, specs, cfg, WORLD)


def _exec_grads(step):
    rng = np.random.default_rng(10 + step)
    return [torch.from_numpy(rng.standard_normal((WORLD,) + s)
                             .astype(np.float32)) for s in ((600,), (64, 256))]


def _rand_fn(step, ranks):
    def rand_fn(bucket_idx, n):
        per = n // len(ranks)
        g = np.random.default_rng(1000 * step + bucket_idx).integers(
            -2**31, 2**31, size=(WORLD, per), dtype=np.int64).astype(np.int32)
        return torch.from_numpy(g[ranks].reshape(-1)).view(torch.uint32)
    return rand_fn


def run_cases(coll, ranks):
    """Every case on the held ranks ``ranks`` (a list of rank indices):
    {case: tensors}."""
    x, rand = _inputs()
    out = {}
    for case in CASES:
        algo = "dsar_split_allgather" if case == "dsar_qsgd4" else case
        qsgd = QSGDConfig(4, 1024) if case == "dsar_qsgd4" else None
        f = ar.make_sparse_allreduce(coll, N, K, B, algorithm=algo, qsgd=qsgd)
        out[case] = [f(x[ranks], rand[ranks] if qsgd else None).contiguous()]
    for case in EXEC:
        algo = {"exec_dsar_qsgd4": "dsar_split_allgather",
                "exec_split_allgather": "ssar_split_allgather",
                "exec_rearranged": "ssar_rearranged_rs"}[case]
        plan = _plan(algo)
        res = {n: r[ranks] for n, r in plan.init_residuals().items()}
        got = []
        for step in range(2):
            grads = [g[ranks] for g in _exec_grads(step)]
            leaves, res = executor.execute_plan(
                plan, grads, res, coll=coll, rand_fn=_rand_fn(step, ranks))
            got += leaves + [res[n] for n in sorted(res)]
        out[case] = [t.contiguous() for t in got]
    # the primitives themselves
    y = torch.arange(WORLD * 12, dtype=torch.float32).reshape(WORLD, 3, 4)[
        ranks] + 0.25
    out["primitives"] = [coll.all_to_all(y, axis=1), coll.all_gather(y, axis=0),
                         coll.psum(y), coll.psum(y.to(torch.int32)),
                         coll.ppermute(y, [(0, 2), (2, 0), (1, 3)]),
                         coll.axis_rank()]
    return out


def _worker(rank, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        torch.set_num_threads(1)
        res = run_cases(ProcessGroupCollectives(device="cpu"), [rank])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_worker, args=(r, port, d))
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
    stacked = run_cases(StackedCollectives(WORLD, device="cpu"),
                        list(range(WORLD)))
    return per_rank, stacked


@pytest.mark.parametrize("case", CASES + EXEC + ("primitives",))
def test_process_group_bit_equal_to_stacked(results, case):
    per_rank, stacked = results
    for r in range(WORLD):
        for got, want in zip(per_rank[r][case], stacked[case]):
            if case.startswith("exec") and want.shape[0] != WORLD:
                # synced leaves: one copy, the same on every rank
                assert torch.equal(got, want), (case, r)
                continue
            assert torch.equal(got[0], want[r]), (case, r)


def test_stacked_primitives_follow_jax_semantics(results):
    _, stacked = results
    a2a, gathered, summed, isum, perm, rank = stacked["primitives"]
    y = torch.arange(WORLD * 12, dtype=torch.float32).reshape(WORLD, 3, 4) \
        + 0.25
    # all_to_all (tiled) on axis 1: rank d gets chunk d of every source
    for d in range(WORLD):
        assert torch.equal(a2a[d], torch.stack([y[s, :, d] for s in
                                                range(WORLD)], dim=1))
    assert torch.equal(gathered[1], torch.cat(list(y), dim=0))
    assert torch.equal(summed[2], y[0] + y[1] + y[2] + y[3])
    assert torch.equal(isum[0], y.to(torch.int32).sum(0))
    assert torch.equal(perm[2], y[0]) and torch.equal(perm[0], y[2])
    assert torch.equal(perm[3], y[1]) and not perm[1].any()
    assert rank.tolist() == list(range(WORLD))
