"""The port's serving path against the JAX package's (DESIGN.md §8).

The invariants the reference's ``tests/test_serve.py`` holds, held here
for the port and across the two packages:

* continuous batching is invisible to a request: its tokens equal a
  per-request B = 1 ``ServeEngine.generate``, token for token, whatever
  slots, arrivals and retirements happen around it; and the port's
  engines give the reference engines' tokens on the same weights;
* the row-stream activation exchange is exact: bit-equal to the dense
  sum while occupancy stays under the stream capacity.

Tolerances: greedy tokens, scheduler state, plan signatures and wire
bytes are compared exactly. Exchange results: bit-equal to the port's
dense path, and to the reference's at p = 2 (a two-term sum has one
rounding in any order); at p = 4 and 8 the reference's XLA sum may group
its terms otherwise, so allclose at rtol 1e-6, atol 1e-6.
"""
import os
import socket
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.comm import build_serve_plan as jax_build_serve_plan
from repro.comm import exchange_activation_spmd as jax_exchange_spmd
from repro.core import sparse_stream as jss
from repro.core.cost_model import DEFAULT_NET
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro.runtime.adapt import AdaptConfig as JaxAdaptConfig
from repro.runtime.adapt import AdaptiveController as JaxAdaptiveController
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import ContinuousServeEngine as JaxContinuousServeEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import obs as obs_mod
from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                          StackedCollectives)
from repro_torch.comm.executor import (exchange_activation,
                                       exchange_activation_spmd)
from repro_torch.comm.plan import build_serve_plan
from repro_torch.core import sparse_stream as ss
from repro_torch.core.cost_model import NetworkParams
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.obs import audit_serve_plan
from repro_torch.runtime.adapt import AdaptConfig, AdaptiveController
from repro_torch.runtime.faults import (FaultInjectionError, FaultInjector,
                                        FaultPlan, FaultSpec)
from repro_torch.serve import (ContinuousScheduler, ContinuousServeEngine,
                               Request, ServeConfig, ServeEngine,
                               build_slot_decode_step, insert_slot_state,
                               poisson_trace, truncate_at_eos)
from repro_torch.serve import run_serve

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
NET = NetworkParams(alpha=DEFAULT_NET.alpha,
                    link_bytes_per_s=DEFAULT_NET.link_bytes_per_s)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads: several pytest workers share the host, and torch's
    default of every core each oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(reference model, its params, port model, the same params)."""
    jcfg = JaxModelConfig(**TINY, dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


def _requests(rng, specs, cls=Request):
    return [cls(rid=i, prompt=rng.integers(0, 256, n), max_new_tokens=m,
                arrival=a) for i, (n, m, a) in enumerate(specs)]


def _per_request(model, params, reqs, cache_len, eos_id=None):
    eng = ServeEngine(model, params, cache_len=cache_len, device="cpu")
    return {r.rid: truncate_at_eos(
        eng.generate(r.prompt[None], max_new_tokens=r.max_new_tokens)[0],
        eos_id) for r in reqs}


def _assert_outputs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for rid in want:
        assert np.asarray(got[rid]).tolist() == \
            np.asarray(want[rid]).tolist(), rid


# --------------------------------------------------------------------------
# Row streams and the activation exchange
# --------------------------------------------------------------------------

def _row_sparse(p, t, d, nnz_rows, seed=0):
    rng = np.random.default_rng(seed)
    parts = np.zeros((p, t, d), np.float32)
    for s in range(p):
        for r in rng.choice(t, nnz_rows, replace=False):
            parts[s, r] = rng.standard_normal(d)
    return parts


def test_row_stream_roundtrip_exact_and_matches_reference():
    x = _row_sparse(1, 16, 8, 3)[0]
    st = ss.from_row_mask(torch.from_numpy(x),
                          torch.from_numpy((x != 0).any(1)), cap=4)
    jst = jss.from_row_mask(jnp.asarray(x), jnp.asarray((x != 0).any(1)),
                            cap=4)
    assert int(st.nnz) == 3 and st.capacity == 4
    np.testing.assert_array_equal(st.idx.numpy(), np.asarray(jst.idx))
    np.testing.assert_array_equal(st.val.numpy(), np.asarray(jst.val))
    assert int(st.idx[-1]) == ss.SENTINEL and not st.val[-1].any()
    back = ss.densify_rows(st, 16)
    np.testing.assert_array_equal(back.numpy(), x)


def test_row_stream_overflow_clamps():
    """Over capacity the round trip is lossy (why the engine's occupancy
    guard exists); nnz saturates at cap and the kept rows are the lowest
    indices, intact, as in the reference."""
    x = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    st = ss.from_row_mask(torch.from_numpy(x), torch.ones(8, dtype=torch.bool),
                          cap=4)
    jst = jss.from_row_mask(jnp.asarray(x), jnp.ones((8,), bool), cap=4)
    assert int(st.nnz) == int(jst.nnz) == 4
    back = ss.densify_rows(st, 8).numpy()
    np.testing.assert_array_equal(back, np.asarray(jss.densify_rows(jst, 8)))
    assert not np.array_equal(back, x)
    np.testing.assert_array_equal(back[:4], x[:4])
    assert not back[4:].any()


def test_row_stream_batched_leading_axes():
    parts = _row_sparse(3, 16, 8, 2, seed=4)
    x = torch.from_numpy(parts)
    st = ss.from_row_mask(x, (x != 0).any(-1), cap=4)
    assert tuple(st.idx.shape) == (3, 4) and tuple(st.val.shape) == (3, 4, 8)
    assert st.nnz.tolist() == [2, 2, 2]
    assert torch.equal(ss.densify_rows(st, 16), x)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_exchange_spmd_sparse_equals_dense_and_reference(p):
    parts = _row_sparse(p, 16, 8, 3)
    x = torch.from_numpy(parts)
    dense = exchange_activation_spmd(x, "dense")
    sparse = exchange_activation_spmd(x, "stream_gather@4")
    assert torch.equal(dense, sparse)
    ref = np.asarray(jax_exchange_spmd(jnp.asarray(parts), "dense"))
    if p == 2:
        np.testing.assert_array_equal(dense.numpy(), ref)
    np.testing.assert_allclose(dense.numpy(), ref, rtol=1e-6, atol=1e-6)
    # over capacity the stream drops rows: a parity break, not silence
    over = exchange_activation_spmd(x, "stream_gather@2")
    assert not torch.equal(over, dense)


@pytest.mark.parametrize("p", [2, 8])
def test_exchange_per_rank_over_stacked_collectives(p):
    """The per-rank exchange over StackedCollectives: the stream
    all-gather's densify + rank-order sum is bit-equal to psum, and to
    the stacked form, on every rank."""
    parts = torch.from_numpy(_row_sparse(p, 16, 8, 3, seed=p))
    coll = StackedCollectives(p, device="cpu")
    dense = exchange_activation(parts, "dense", coll=coll)
    sparse = exchange_activation(parts, "stream_gather@4", coll=coll)
    spmd = exchange_activation_spmd(parts, "dense")
    for r in range(p):
        assert torch.equal(sparse[r], dense[r])
        assert torch.equal(sparse[r], spmd)


WORLD = 2


def _exchange_worker(rank, port, out_dir, parts):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        torch.set_num_threads(1)
        coll = ProcessGroupCollectives(device="cpu")
        mine = parts[rank:rank + 1]
        out = {alg: exchange_activation(mine, alg, coll=coll)
               for alg in ("dense", "stream_gather@4")}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_exchange_per_rank_over_gloo():
    """One rank a process over gloo: each rank's stream exchange is
    bit-equal to its dense one and to the stacked form."""
    parts = torch.from_numpy(_row_sparse(WORLD, 16, 8, 3, seed=9))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_exchange_worker,
                             args=(r, port, d, parts)) for r in range(WORLD)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=120)
        assert all(pr.exitcode == 0 for pr in procs)
        outs = [torch.load(os.path.join(d, f"rank{r}.pt"))
                for r in range(WORLD)]
    want = exchange_activation_spmd(parts, "dense")
    for out in outs:
        assert torch.equal(out["dense"][0], want)
        assert torch.equal(out["stream_gather@4"][0], want)


# --------------------------------------------------------------------------
# ServePlan and the adaptive controller
# --------------------------------------------------------------------------

def test_serve_plan_selection_and_signature_match_reference():
    plan = build_serve_plan(2, 16, 128, algorithm="dense")
    jplan = jax_build_serve_plan(2, 16, 128, algorithm="dense")
    assert plan.signature() == jplan.signature() == "act0=dense"
    low = plan.replan({"act0": 2.0})
    assert low.signature() == "act0=stream_gather@4"
    assert low.version == plan.version + 1
    assert low.wire_bytes() < plan.wire_bytes()
    high = low.replan({"act0": 14.0})
    assert high.signature() == "act0=dense"
    assert low.switch_forced("act0", "stream_gather@4", "dense", 4.0)
    assert not low.switch_forced("act0", "stream_gather@4", "dense", 3.0)
    assert not plan.switch_forced("act0", "dense", "stream_gather@4", 99.0)
    forced = plan.replan(algorithms={"act0": "stream_gather@8"})
    assert forced.signature() == "act0=stream_gather@8"
    assert forced.buckets[0].cap == 8
    # the same selection as the reference's over a ladder of occupancies
    for p, t, d in ((2, 16, 128), (4, 64, 768), (8, 8, 64)):
        plan = build_serve_plan(p, t, d, min_cap=2, headroom=1.5)
        jplan = jax_build_serve_plan(p, t, d, min_cap=2, headroom=1.5)
        for nnz in (0.0, 0.5, 1.0, 2.7, 5.0, 13.0, 30.0, 64.0):
            a, b = plan.replan({"act0": nnz}), jplan.replan({"act0": nnz})
            assert a.signature() == b.signature(), (p, t, d, nnz)
            assert a.wire_bytes() == b.wire_bytes()
            assert a.describe() == b.describe()


def test_adaptive_controller_drives_serve_plan_as_reference():
    """The port's AdaptiveController on a ServePlan, on the reference's
    default network: the same accepted plans as the reference's."""
    cfg = dict(window=2, patience=1, calibrate=False, pod_sparse=False)
    ctrl = AdaptiveController(build_serve_plan(2, 16, 128), NET,
                              cfg=AdaptConfig(**cfg))
    jctrl = JaxAdaptiveController(jax_build_serve_plan(2, 16, 128),
                                  cfg=JaxAdaptConfig(**cfg))
    sigs, jsigs = [], []
    for occ in [2.0] * 4 + [14.0] * 4 + [3.0] * 4:
        a, b = ctrl.observe_step({"act0": occ}), jctrl.observe_step(
            {"act0": occ})
        sigs.append(a.signature() if a is not None else None)
        jsigs.append(b.signature() if b is not None else None)
    assert sigs == jsigs
    assert "act0=stream_gather@4" in sigs and "act0=dense" in sigs
    assert ctrl.swaps == jctrl.swaps >= 2


def test_audit_serve_plan_records_and_needs_a_network():
    plan = build_serve_plan(4, 16, 64).replan({"act0": 2.0})
    reg = obs_mod.MetricsRegistry(enabled=True)
    aud = audit_serve_plan(plan, net=NET, device="cpu", reps=1,
                           registry=reg)
    (sample,) = aud.samples
    assert sample["algorithm"] == "stream_gather@4"
    assert sample["kind"] == "serve_bucket" and sample["measured_s"] > 0
    assert reg.events_named("audit/algorithm_residual")
    with pytest.raises(ValueError, match="network"):
        audit_serve_plan(plan, net=None, device="cpu")


# --------------------------------------------------------------------------
# The scheduler
# --------------------------------------------------------------------------

def test_scheduler_lifecycle_and_fifo():
    reqs = [Request(rid=i, prompt=np.array([1, 2]), max_new_tokens=3,
                    arrival=a) for i, a in enumerate([0, 0, 5, 0])]
    sched = ContinuousScheduler(2, reqs, eos_id=99)
    admits = sched.admit_ready()
    assert [(i, r.rid) for i, r in admits] == [(0, 0), (1, 1)]   # FIFO
    for i, r in admits:
        sched.install(i, r, first_token=7)
    assert sched.active_count == 2 and not sched.admit_ready()
    assert sched.record(0, 99) is True                             # EOS
    assert sched.completed[0].tolist() == [7, 99]
    admits = sched.admit_ready()
    assert [(i, r.rid) for i, r in admits] == [(0, 3)]
    sched.install(0, admits[0][1], first_token=1)
    sched.record(1, 1)
    assert sched.record(1, 2) is True          # 3 tokens incl. install
    assert sched.completed[1].tolist() == [7, 1, 2]
    sched.record(0, 1), sched.record(0, 2)
    assert sched.active_count == 0 and sched.waiting
    sched.skip_to_next_arrival()
    assert sched.clock == 5.0
    assert [(i, r.rid) for i, r in sched.admit_ready()] == [(0, 2)]


def test_scheduler_matches_reference_on_a_random_drive():
    """The same operations on both packages' schedulers (admissions,
    records, deadline and overflow shedding, idle skips) leave the same
    slots, completions, lifecycles, sheds and latency statistics."""
    rng = np.random.default_rng(5)
    specs = [(int(rng.integers(1, 9)), int(rng.integers(1, 7)), float(a))
             for a in poisson_trace(24, rate=2.0, seed=3)]
    scheds = [ContinuousScheduler(3, _requests(np.random.default_rng(0),
                                               specs), eos_id=5),
              JaxScheduler(3, _requests(np.random.default_rng(0), specs,
                                        JaxRequest), eos_id=5)]
    draw = np.random.default_rng(6)
    steps = 0
    while not scheds[0].done:
        assert not scheds[1].done
        first = draw.integers(0, 8, 3)
        admitted = []
        for sched in scheds:
            sched.shed_overdue(4.0)
            adm = sched.admit_ready()
            for i, r in adm:
                sched.install(i, r, int(first[i]))
            admitted.append([(i, r.rid) for i, r in adm])
            sched.shed_overflow(3)
        assert admitted[0] == admitted[1]
        active = [s.active_mask.tolist() for s in scheds]
        assert active[0] == active[1]
        if not any(active[0]):
            for sched in scheds:
                sched.skip_to_next_arrival()
            continue
        toks = draw.integers(0, 8, 3)
        for sched in scheds:
            for i in np.nonzero(sched.active_mask)[0]:
                sched.record(int(i), int(toks[i]))
            sched.advance()
        steps += 1
    assert scheds[1].done and steps > 10
    a, b = scheds
    assert a.shed == b.shed
    assert set(a.shed.values()) == {"deadline", "queue_full"}
    assert a.retirements == b.retirements
    assert a.lifecycle == b.lifecycle
    _assert_outputs_equal(a.completed, b.completed)
    sa, sb = a.latency_stats(), b.latency_stats()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])


def test_poisson_trace_deterministic():
    a = poisson_trace(16, rate=0.5, seed=7)
    np.testing.assert_array_equal(a, poisson_trace(16, rate=0.5, seed=7))
    assert (np.diff(a) > 0).all() and a.shape == (16,)
    assert not np.array_equal(a, poisson_trace(16, rate=0.5, seed=8))
    from repro.serve import poisson_trace as jax_poisson_trace
    np.testing.assert_array_equal(a, jax_poisson_trace(16, rate=0.5, seed=7))


def test_truncate_at_eos():
    t = np.array([3, 9, 4, 9, 5])
    assert truncate_at_eos(t, 9).tolist() == [3, 9]
    assert truncate_at_eos(t, 77).tolist() == t.tolist()
    assert truncate_at_eos(t, None).tolist() == t.tolist()


def test_serve_config_targets_and_deadline():
    assert ServeConfig().effective_shed_deadline() is None
    assert ServeConfig(slo_ttft_p99=4.0).effective_shed_deadline() is None
    assert ServeConfig(slo_ttft_p99=4.0,
                       queue_limit=2).effective_shed_deadline() == 4.0
    assert ServeConfig(shed_deadline=3).effective_shed_deadline() == 3.0
    assert ServeConfig(slo_ttft_p99=4, slo_e2e_p99=9).slo_targets() == \
        JaxServeConfig(slo_ttft_p99=4, slo_e2e_p99=9).slo_targets()


# --------------------------------------------------------------------------
# The engines
# --------------------------------------------------------------------------

def test_serve_engine_matches_reference(models, mesh4x2):
    jmodel, jparams, model, params = models
    prompts = np.random.default_rng(0).integers(0, 256, (4, 8)).astype(
        np.int32)
    eng = ServeEngine(model, params, cache_len=64, device="cpu")
    out = eng.generate(prompts, max_new_tokens=6)
    assert out.shape == (4, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, eng.generate(prompts, 6))
    jeng = JaxServeEngine(jmodel, mesh4x2, jparams, cache_len=64)
    np.testing.assert_array_equal(out, jeng.generate(prompts, 6))


def test_serve_engine_needs_a_card_by_default(models):
    _, _, model, params = models
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousServeEngine(model, params)


RAGGED = [(3, 6, 0), (7, 4, 0), (5, 8, 0), (10, 5, 1), (4, 7, 3), (6, 6, 8),
          (1, 4, 9)]


@pytest.fixture(scope="module")
def ragged(models, mesh4x2):
    """Ragged prompts, staggered arrivals and an EOS id that fires mid-
    stream for request 0; the port's per-request references and the
    reference engine's continuous outputs."""
    jmodel, jparams, model, params = models
    reqs = _requests(np.random.default_rng(0), RAGGED)
    plain = _per_request(model, params, reqs, cache_len=32)
    eos = int(plain[0][2])
    want = {rid: truncate_at_eos(t, eos) for rid, t in plain.items()}
    jreqs = _requests(np.random.default_rng(0), RAGGED, JaxRequest)
    jres = JaxContinuousServeEngine(jmodel, mesh4x2, jparams, cache_len=32,
                                    batch_size=4, eos_id=eos).run(jreqs)
    return reqs, eos, want, jres


@pytest.mark.parametrize("dispatch", ["adaptive", "dense"])
def test_continuous_matches_per_request_and_reference(models, ragged,
                                                      dispatch):
    """Every request's continuous-batching output equals its own B = 1
    greedy decode and the reference engine's; the step log and the
    latency statistics are the reference's (the schedule is the same)."""
    _, _, model, params = models
    reqs, eos, want, jres = ragged
    eng = ContinuousServeEngine(model, params, cache_len=32, batch_size=4,
                                eos_id=eos, dispatch=dispatch, device="cpu")
    res = eng.run(reqs)
    _assert_outputs_equal(res.outputs, want)
    _assert_outputs_equal(res.outputs, jres.outputs)
    assert res.tokens == jres.tokens == sum(len(t) for t in want.values())
    assert res.decode_steps == jres.decode_steps
    assert [(r["step"], r["active"]) for r in res.step_log] == \
        [(r["step"], r["active"]) for r in jres.step_log]
    assert res.latency == jres.latency
    assert res.swap_log == [] and res.wire_bytes == 0.0
    # the engine is reusable: a second run gives the same tokens
    _assert_outputs_equal(eng.run(reqs).outputs, want)


def test_continuous_reads_the_device_once_a_step(models, monkeypatch):
    """One host wait a decode step (its greedy tokens) and one an
    admission (its first token), through the engine's one read-back."""
    from repro_torch.serve import sparse_decode

    _, _, model, params = models
    calls = []
    real = sparse_decode._readback
    monkeypatch.setattr(sparse_decode, "_readback",
                        lambda t: calls.append(tuple(t.shape)) or real(t))
    reqs = _requests(np.random.default_rng(1), [(4, 5, 0), (6, 3, 0),
                                                (3, 4, 2)])
    res = ContinuousServeEngine(model, params, cache_len=32, batch_size=2,
                                device="cpu").run(reqs)
    assert calls.count((2,)) == res.decode_steps
    assert calls.count((1,)) == len(reqs)


def test_shedding_accounts_for_every_request(models, mesh4x2):
    """A bounded queue and a deadline: every request leaves exactly once,
    through the outputs or the shed list, as in the reference, and the
    served ones keep their unloaded outputs."""
    jmodel, jparams, model, params = models
    specs = [(4, 6, 0.0)] * 3 + [(3, 5, 0.5 + 0.1 * i) for i in range(6)]
    cfg = dict(slo_ttft_p99=3.0, queue_limit=2)
    obs = obs_mod.configure(metrics=True, set_as_default=False)
    res = ContinuousServeEngine(
        model, params, cache_len=32, batch_size=2, device="cpu", obs=obs,
        serve_cfg=ServeConfig(**cfg)).run(
            _requests(np.random.default_rng(2), specs))
    jres = JaxContinuousServeEngine(
        jmodel, mesh4x2, jparams, cache_len=32, batch_size=2,
        serve_cfg=JaxServeConfig(**cfg)).run(
            _requests(np.random.default_rng(2), specs, JaxRequest))
    assert res.shed and res.shed == jres.shed
    assert set(res.shed.values()) == {"queue_full", "deadline"}
    assert set(res.outputs) | set(res.shed) == set(range(len(specs)))
    assert not set(res.outputs) & set(res.shed)
    _assert_outputs_equal(res.outputs, jres.outputs)
    plain = _per_request(model, params, _requests(
        np.random.default_rng(2), specs), cache_len=32)
    _assert_outputs_equal(res.outputs, {r: plain[r] for r in res.outputs})
    assert [e.rule for e in res.health if e.rule == "serve_shed"]
    assert obs.metrics.counter("serve/shed_requests").value == len(res.shed)


def test_chaos_tick_retries_and_stuck_fault_aborts(models, tmp_path):
    """A collective raise before a decode tick is retried and the run's
    outputs are the unfaulted run's, with the planned retry events; a
    fault that outlasts the retry budget aborts with the blackbox."""
    _, _, model, params = models
    reqs = _requests(np.random.default_rng(3), [(4, 6, 0), (5, 7, 1),
                                                (3, 5, 2)])
    clean = ContinuousServeEngine(model, params, cache_len=32, batch_size=2,
                                  device="cpu").run(reqs)
    obs = obs_mod.configure(metrics=True, set_as_default=False)
    inj = FaultInjector(FaultPlan(specs=(
        FaultSpec(kind="collective", step=2),
        FaultSpec(kind="collective", step=5, repeat=2))))
    res = ContinuousServeEngine(model, params, cache_len=32, batch_size=2,
                                device="cpu", obs=obs,
                                injector=inj).run(reqs)
    _assert_outputs_equal(res.outputs, clean.outputs)
    assert inj.fired_total == 3
    retries = obs.metrics.events_named("recovery/serve_retry")
    assert [e["attempt"] for e in retries] == [1, 1, 2]
    assert obs.metrics.counter("serve/retries").value == 3
    bb = tmp_path / "blackbox.json"
    obs2 = obs_mod.configure(metrics=True, recorder=str(bb),
                             set_as_default=False)
    stuck = FaultInjector(FaultPlan(specs=(
        FaultSpec(kind="collective", step=1, repeat=3),)))
    with pytest.raises(FaultInjectionError):
        ContinuousServeEngine(model, params, cache_len=32, batch_size=2,
                              device="cpu", obs=obs2,
                              injector=stuck).run(reqs)
    assert bb.exists()


def test_slo_verdicts_and_spans(models):
    _, _, model, params = models
    reqs = _requests(np.random.default_rng(4), [(4, 8, 0)] * 4)
    obs = obs_mod.configure(trace=True, metrics=True, set_as_default=False)
    res = ContinuousServeEngine(
        model, params, cache_len=32, batch_size=2, device="cpu", obs=obs,
        serve_cfg=ServeConfig(slo_ttft_p99=1.0, slo_e2e_p99=100.0)).run(reqs)
    assert [(e.rule, e.subject) for e in res.health] == [("serve_slo",
                                                          "ttft")]
    names = {e["name"] for e in obs.tracer.events}
    assert {"serve/admit", "serve/decode_step"} <= names
    m = obs.metrics
    assert len(m.histogram("serve/occupancy").values) == res.decode_steps
    assert len(m.histogram("serve/ttft_steps").values) == 4
    assert m.gauge("serve/tok_per_s").value == res.tok_per_s > 0


def test_insert_slot_state_writes_only_its_slot(models):
    _, _, model, params = models
    state = model.init_decode_state(3, 16, device="cpu")
    state = state._replace(pos=torch.tensor([5, 6, 7], dtype=torch.int32))
    state.kv.k.normal_()
    before = state.kv.k.clone()
    _, sub = model.prefill(params, {"tokens": torch.arange(
        4, dtype=torch.int32)[None]}, 16)
    out = insert_slot_state(model.cfg, state, sub, 1)
    assert out.kv.k is state.kv.k and state.pos.tolist() == [5, 4, 7]
    assert torch.equal(state.kv.k[:, [0, 2]], before[:, [0, 2]])
    assert torch.equal(state.kv.k[:, 1], sub.kv.k[:, 0])


# --------------------------------------------------------------------------
# The ssm, hybrid, vlm and encoder families
# --------------------------------------------------------------------------

FAMILY_TINY = {
    "ssm": dict(TINY, family="ssm", num_layers=3, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=4),
    "hybrid": dict(TINY, family="hybrid", num_layers=4, ssm_state=16,
                   ssm_head_dim=16, ssm_chunk=4, attn_every=2),
    "vlm": dict(TINY, family="vlm", num_layers=4, cross_attn_every=2,
                num_image_tokens=8, vision_dim=48),
    "encoder": dict(TINY, family="encoder", frontend_dim=32, act_fn="gelu",
                    causal=False),
}
# prompts of whole SSD chunks (4 tokens), as the scan needs; 3 slots, so
# requests retire and others take their slots
SSM_RAGGED = [(4, 6, 0), (8, 4, 0), (4, 8, 0), (12, 5, 1), (8, 7, 3),
              (4, 6, 8)]


def _family_models(fam, seed=0):
    kw = FAMILY_TINY[fam]
    jcfg = JaxModelConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if fam == "vlm":       # non-zero gates: the image counts
        cross = jparams["blocks"]["cross"]
        cross["xattn"]["gate"] = jnp.full_like(cross["xattn"]["gate"], 0.5)
        cross["mlp_gate"] = jnp.full_like(cross["mlp_gate"], -0.7)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
def test_continuous_ssm_families_match_per_request_and_reference(fam,
                                                                 mesh4x2):
    """The ssm and hybrid families under continuous batching: every
    request's tokens equal its own B = 1 generate, and the reference
    engine's on the same weights; each admission splices the prefill's
    conv window and SSM state (and the hybrid's KV caches) into its
    slot."""
    jmodel, jparams, model, params = _family_models(fam)
    reqs = _requests(np.random.default_rng(5), SSM_RAGGED)
    want = _per_request(model, params, reqs, cache_len=32)
    eng = ContinuousServeEngine(model, params, cache_len=32, batch_size=3,
                                device="cpu")
    res = eng.run(reqs)
    _assert_outputs_equal(res.outputs, want)
    jres = JaxContinuousServeEngine(
        jmodel, mesh4x2, jparams, cache_len=32, batch_size=3).run(
        _requests(np.random.default_rng(5), SSM_RAGGED, JaxRequest))
    _assert_outputs_equal(res.outputs, jres.outputs)
    assert res.decode_steps == jres.decode_steps
    jeng = JaxServeEngine(jmodel, mesh4x2, jparams, cache_len=32)
    prompts = np.stack([r.prompt[:4] for r in reqs[:4]]).astype(np.int32)
    np.testing.assert_array_equal(
        ServeEngine(model, params, cache_len=32, device="cpu").generate(
            prompts, 5), jeng.generate(prompts, 5))


def test_vlm_static_generate_matches_reference(mesh4x2):
    """ServeEngine.generate with image embeddings: the vlm's tokens equal
    the reference engine's; other image embeddings change them."""
    jmodel, jparams, model, params = _family_models("vlm")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, 256, (4, 8)).astype(np.int32)
    image = rng.standard_normal((4, 8, 48)).astype(np.float32)
    eng = ServeEngine(model, params, cache_len=32, device="cpu")
    out = eng.generate(prompts, 6, image_embeds=image)
    jeng = JaxServeEngine(jmodel, mesh4x2, jparams, cache_len=32)
    np.testing.assert_array_equal(
        out, jeng.generate(prompts, 6, image_embeds=image))
    other = eng.generate(prompts, 6, image_embeds=-image)
    assert not np.array_equal(out, other)


def test_unserved_families_and_unknown_models_raise(mesh4x2):
    """Continuous batching refuses the vlm and the encoder with the
    reference's message, and insert_slot_state the vlm's caches; the
    encoder has no decode, so its ServeEngine refuses; an unknown
    run_serve model raises."""
    for fam in ("vlm", "encoder"):
        jmodel, jparams, model, params = _family_models(fam)
        msg = f"continuous batching: family '{fam}'"
        with pytest.raises(NotImplementedError, match=msg):
            ContinuousServeEngine(model, params, device="cpu")
        with pytest.raises(NotImplementedError, match=msg):
            JaxContinuousServeEngine(jmodel, mesh4x2, jparams)
    _, _, vlm, _ = _family_models("vlm")
    with pytest.raises(NotImplementedError, match="vlm caches"):
        insert_slot_state(vlm.cfg, None, None, 0)
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(model, params, device="cpu").generate(
            np.zeros((1, 4), np.int32), 2)
    with pytest.raises(ValueError, match="unknown model"):
        run_serve.build(False, model="nope", device="cpu")


def test_insert_slot_state_splices_ssm_states():
    """insert_slot_state writes the B = 1 prefill's conv window, SSM state
    and (hybrid) KV caches into one slot, in place, and nothing else."""
    _, _, model, params = _family_models("hybrid")
    state = model.init_decode_state(3, 16, device="cpu")
    state = state._replace(pos=torch.tensor([5, 6, 7], dtype=torch.int32))
    for t in (state.conv, state.ssm, state.kv.k):
        t.normal_()
    before = [t.clone() for t in (state.conv, state.ssm, state.kv.k)]
    _, sub = model.prefill(params, {"tokens": torch.arange(
        8, dtype=torch.int32)[None]}, 16)
    out = insert_slot_state(model.cfg, state, sub, 1)
    assert out.ssm is state.ssm and state.pos.tolist() == [5, 8, 7]
    for t, b, src in zip((state.conv, state.ssm, state.kv.k), before,
                         (sub.conv, sub.ssm, sub.kv.k)):
        assert torch.equal(t[:, [0, 2]], b[:, [0, 2]])
        assert torch.equal(t[:, 1], src[:, 0])


# --------------------------------------------------------------------------
# Serve-time MoE dispatch: the continuous engine's plan path
# --------------------------------------------------------------------------

MOE_TINY = dict(TINY, family="moe", num_experts=4, experts_per_token=2,
                moe_d_ff=64, capacity_factor=4.0)


@pytest.fixture(scope="module")
def moe_models():
    """The reference's MoE serve model (its tests/test_serve.py
    ``_moe_cfg``): (reference model, params, port model, the same params)."""
    jcfg = JaxModelConfig(**MOE_TINY, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    cfg = ModelConfig(**MOE_TINY, dtype=torch.float32,
                      param_dtype=torch.float32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


# the reference's drain-shaped workload: a burst fills the slots, the
# short requests retire, and two long ones drain at low occupancy
MOE_DRAIN = [(4, 6, 0), (6, 5, 0), (3, 6, 0), (5, 4, 0), (7, 5, 0),
             (4, 5, 0), (5, 22, 0), (6, 20, 1)]
# a late burst that outgrows the stream capacity after the drain
MOE_BURST = [(4, 18, 0), (5, 18, 0)] + [(4, 8, 12 + i * 0.01)
                                        for i in range(6)]


@pytest.fixture(scope="module")
def moe_drain(moe_models):
    _, _, model, params = moe_models
    reqs = _requests(np.random.default_rng(1), MOE_DRAIN)
    return reqs, _per_request(model, params, reqs, cache_len=32)


def test_continuous_moe_dense_matches_per_request(moe_models, moe_drain,
                                                  mesh4x2):
    """Dense dispatch: every request equals its own B = 1 generate, and
    the reference engine's output on the same weights."""
    jmodel, jparams, model, params = moe_models
    reqs, refs = moe_drain
    res = ContinuousServeEngine(model, params, cache_len=32, batch_size=8,
                                dispatch="dense", device="cpu").run(reqs)
    _assert_outputs_equal(res.outputs, refs)
    jres = JaxContinuousServeEngine(
        jmodel, mesh4x2, jparams, cache_len=32, batch_size=8,
        dispatch="dense").run(_requests(np.random.default_rng(1), MOE_DRAIN,
                                        JaxRequest))
    _assert_outputs_equal(res.outputs, jres.outputs)
    assert res.wire_bytes == jres.wire_bytes > 0
    assert [r["signature"] for r in res.step_log] == \
        [r["signature"] for r in jres.step_log]


def test_continuous_moe_adaptive_exact_and_swaps(moe_models, moe_drain,
                                                 mesh4x2):
    """The adaptive engine emits exactly the dense engine's tokens, swaps
    dense -> stream on telemetry during the drain, puts fewer modeled
    bytes on the wire, and its swap log, step signatures and wire bytes
    equal the reference engine's under the same NetworkParams."""
    jmodel, jparams, model, params = moe_models
    reqs, refs = moe_drain
    rd = ContinuousServeEngine(model, params, cache_len=32, batch_size=8,
                               dispatch="dense", device="cpu").run(reqs)
    adap = ContinuousServeEngine(model, params, cache_len=32, batch_size=8,
                                 dispatch="adaptive", net=NET, device="cpu")
    ra = adap.run(reqs)
    _assert_outputs_equal(ra.outputs, refs)
    _assert_outputs_equal(ra.outputs, rd.outputs)
    telem_swaps = [s for s in ra.swap_log if s["reason"] == "telemetry"]
    assert telem_swaps and "stream_gather" in telem_swaps[0]["signature"]
    assert ra.wire_bytes < rd.wire_bytes
    sparse_steps = [r for r in ra.step_log
                    if "stream_gather" in r["signature"]]
    assert sparse_steps and max(r["active"] for r in sparse_steps) <= 4
    jra = JaxContinuousServeEngine(
        jmodel, mesh4x2, jparams, cache_len=32, batch_size=8,
        dispatch="adaptive", net=DEFAULT_NET).run(
            _requests(np.random.default_rng(1), MOE_DRAIN, JaxRequest))
    assert ra.swap_log == jra.swap_log
    assert [(r["active"], r["signature"], r["wire_bytes"])
            for r in ra.step_log] == [(r["active"], r["signature"],
                                       r["wire_bytes"])
                                      for r in jra.step_log]
    assert ra.wire_bytes == jra.wire_bytes
    # the engine is reusable, and a rerun starts from the adapted plan
    _assert_outputs_equal(adap.run(reqs).outputs, refs)


def test_occupancy_guard_forces_dense(moe_models, mesh4x2):
    """A late burst that outgrows the stream capacity force-demotes the
    plan to dense before any token is computed under an over-capacity
    stream; the output stays exact, and the log is the reference's."""
    jmodel, jparams, model, params = moe_models
    reqs = _requests(np.random.default_rng(2), MOE_BURST)
    refs = _per_request(model, params, reqs, cache_len=32)
    res = ContinuousServeEngine(model, params, cache_len=32, batch_size=8,
                                dispatch="adaptive", net=NET,
                                device="cpu").run(reqs)
    _assert_outputs_equal(res.outputs, refs)
    reasons = [s["reason"] for s in res.swap_log]
    assert "telemetry" in reasons and "occupancy-guard" in reasons
    guard = [s for s in res.swap_log if s["reason"] == "occupancy-guard"][0]
    assert guard["signature"] == "act0=dense"
    # no step ran a stream under more active slots than its capacity
    for r in res.step_log:
        if "stream_gather" in r["signature"]:
            assert r["active"] <= int(r["signature"].split("@")[1])
    jres = JaxContinuousServeEngine(
        jmodel, mesh4x2, jparams, cache_len=32, batch_size=8,
        dispatch="adaptive", net=DEFAULT_NET).run(
            _requests(np.random.default_rng(2), MOE_BURST, JaxRequest))
    assert res.swap_log == jres.swap_log
    _assert_outputs_equal(res.outputs, jres.outputs)


def test_adaptive_moe_engine_needs_a_network(moe_models):
    _, _, model, params = moe_models
    with pytest.raises(ValueError, match="net="):
        ContinuousServeEngine(model, params, dispatch="adaptive",
                              device="cpu")


def test_moe_slot_step_telemetry_is_host_side(moe_models):
    """The plan path's telemetry is host numpy ([active nnz, the plan's
    wire bytes]), built without reading the device."""
    _, _, model, params = moe_models
    plan = build_serve_plan(2, 4, 64).replan(algorithms={
        "act0": "stream_gather@4"})
    step = build_slot_decode_step(model, plan, 16)
    state = model.init_decode_state(4, 16, device="cpu")
    state = state._replace(pos=torch.zeros(4, dtype=torch.int32))
    active = np.array([True, False, True, False])
    _, _, telem = step(params, state, torch.zeros((4, 1), dtype=torch.int32),
                       active)
    assert isinstance(telem["act0"], np.ndarray)
    assert telem["act0"].tolist() == [2.0, plan.wire_bytes()]


def test_run_serve_cli_serve_demo(capsys, monkeypatch):
    """run_serve --model serve-demo --fast on the CPU, static and
    --continuous (adaptive dispatch; the network parameters the card
    would calibrate are the reference's)."""
    monkeypatch.setattr(obs_mod, "_default", obs_mod.OFF)
    monkeypatch.setattr(run_serve, "network", lambda p, device: NET)
    run_serve.main(["--model", "serve-demo", "--fast", "--batch", "4",
                    "--tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "model serve-demo: 2 layers, d=128" in out
    assert "greedy decode is deterministic: OK" in out
    run_serve.main(["--model", "serve-demo", "--fast", "--continuous",
                    "--batch", "4", "--tokens", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "all requests completed: OK" in out
    assert "kB modeled; plan swaps:" in out


def test_run_serve_cli_continuous_chaos(capsys, tmp_path, monkeypatch):
    """run_serve --fast --continuous --chaos on the CPU, as the example's
    chaos smoke: every fault survived, every request served."""
    monkeypatch.setattr(obs_mod, "_default", obs_mod.OFF)
    trace = tmp_path / "t.json"
    run_serve.main(["--fast", "--batch", "4", "--tokens", "8", "--chaos",
                    "0", "--device", "cpu", "--trace", str(trace)])
    out = capsys.readouterr().out
    assert "chaos recovery: survived 3 injected fault(s)" in out
    assert "tok/s on cpu" in out and trace.exists()
    run_serve.main(["--fast", "--batch", "2", "--tokens", "3", "--device",
                    "cpu"])
    assert "greedy decode is deterministic: OK" in capsys.readouterr().out
