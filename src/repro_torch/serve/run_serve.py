"""Serve an LM with greedy decoding on one GPU.

    PYTHONPATH=src python -m repro_torch.serve.run_serve     # static batch
    PYTHONPATH=src python -m repro_torch.serve.run_serve --continuous
    PYTHONPATH=src python -m repro_torch.serve.run_serve --fast --continuous
    PYTHONPATH=src python -m repro_torch.serve.run_serve --model serve-demo \
        --continuous
    PYTHONPATH=src python -m repro_torch.serve.run_serve --chaos 0 \
        --trace t.json --metrics-out m.jsonl

The PyTorch counterpart of ``examples/serve_decode.py``. ``--model
serve-demo`` serves the example's own MoE model (4 layers, d = 256, 8/4
heads, 4 experts top-2 of width 256, capacity factor 4, vocab 2048, f32;
under ``--fast`` 2 layers, d = 128, experts of width 128), random weights
from seed 0, its expert combine over ``p_model`` = 2 shards stacked on
the device (the example's ``model`` axis). ``--model lm-100m`` (the
default) serves ``run_lm.lm_config``'s dense LM (12 layers, d = 768, GQA
12/4 heads, SwiGLU 2048, vocab 32768, f32; 2 layers under ``--fast``).
The requests are the example's: the static run decodes ``--batch``
prompts of 16 tokens; the continuous run (``--continuous``) serves 2 x
``--batch`` requests with Poisson arrivals at 0.5 a decode step (seed 0),
prompts of 4 to 19 tokens and ``--tokens`` / 2 to ``--tokens`` new tokens
each, over ``--batch`` slots with a cache of 128, in adaptive dispatch:
on the MoE model the combine's wire is planned from the step's telemetry
on network parameters calibrated on the run's device
(``utils/calibrate.py`` over ``StackedCollectives(p_model)``), and the
plan swaps are printed with the modeled wire bytes. It prints tok/s,
occupancy, the latency percentiles (decode steps), the SLO verdicts of
``--slo-ttft`` and ``--slo-e2e``, and the shed and retried counts.
``--chaos SEED`` (implies ``--continuous``) injects a seed-derived plan
of recoverable serve faults (a collective raise, a straggler, a stall)
before decode ticks; the run must complete through the tick retries, and
exits non-zero when the plan injected nothing. ``--trace`` exports a
Chrome trace of the prefill, admission and decode spans,
``--metrics-out`` the metrics JSONL; the example's serve-plan drift audit
is not run.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.comm.collectives import StackedCollectives
from repro_torch.core.cost_model import NetworkParams
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.serve import (ContinuousServeEngine, Request, ServeConfig,
                               ServeEngine, poisson_trace)
from repro_torch.train import run_lm
from repro_torch.utils.calibrate import calibrate

CACHE_LEN = 128
P_MODEL = 2         # the example's expert-parallel ``model`` axis


def serve_demo_config(fast: bool) -> ModelConfig:
    """The example's MoE serve-demo model (``examples/serve_decode.py``)."""
    kw = (dict(num_layers=2, d_model=128, d_ff=256) if fast else
          dict(num_layers=4, d_model=256, d_ff=512))
    return ModelConfig(name="serve-demo", family="moe", num_heads=8,
                       num_kv_heads=4, vocab_size=2048, dtype=torch.float32,
                       param_dtype=torch.float32, max_seq_len=256,
                       num_experts=4, experts_per_token=2,
                       moe_d_ff=kw["d_ff"] // 2, capacity_factor=4.0, **kw)


def build(fast: bool, model: str = "lm-100m", device="cuda"):
    """(model, params): lm-100m (2 layers under ``fast``) or the example's
    serve-demo MoE model, random weights from seed 0."""
    if model == "serve-demo":
        cfg = serve_demo_config(fast)
    elif model == "lm-100m":
        cfg, _ = run_lm.lm_config(fast=False)
        if fast:
            cfg = dataclasses.replace(cfg, name="lm-100m-2l", num_layers=2)
    else:
        raise ValueError(f"unknown model {model!r}")
    m = build_model(cfg)
    return m, m.init(torch.Generator().manual_seed(0), device=device)


def network(p_model: int, device) -> NetworkParams:
    """The adaptive dispatch's network parameters, fitted on the stacked
    expert shards on ``device`` (the port carries no default network)."""
    return calibrate(StackedCollectives(p_model, device=device))


def run_static(model, params, batch: int, tokens: int, obs=None,
               device="cuda"):
    engine = ServeEngine(model, params, cache_len=CACHE_LEN, obs=obs,
                         device=device)
    vocab = model.cfg.vocab_size
    prompts = np.random.default_rng(0).integers(
        0, vocab, (batch, 16)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=tokens)
    dt = time.perf_counter() - t0
    print(f"static: {out.shape} tokens for {batch} requests in {dt:.2f}s "
          f"({out.size / dt:.0f} tok/s on {engine.device})")
    print("first request:", out[0].tolist())
    out2 = engine.generate(prompts, max_new_tokens=tokens)
    if not np.array_equal(out, out2):
        raise SystemExit("greedy decode is not deterministic")
    print("greedy decode is deterministic: OK")


def requests(n: int, vocab: int, tokens: int) -> list:
    """The example's trace: Poisson arrivals at 0.5 a step, ragged prompts."""
    rng = np.random.default_rng(0)
    arrivals = poisson_trace(n, rate=0.5, seed=0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(4, 20))),
                    max_new_tokens=int(rng.integers(tokens // 2, tokens + 1)),
                    arrival=float(arrivals[i]))
            for i in range(n)]


def run_continuous(model, params, batch: int, tokens: int, obs=None,
                   slo=None, injector=None, device="cuda"):
    n_req = 2 * batch
    reqs = requests(n_req, model.cfg.vocab_size, tokens)
    moe = model.cfg.family == "moe"
    net = network(P_MODEL, device) if moe else None
    engine = ContinuousServeEngine(model, params, cache_len=CACHE_LEN,
                                   batch_size=batch, dispatch="adaptive",
                                   net=net, p_model=P_MODEL, obs=obs,
                                   serve_cfg=slo, injector=injector,
                                   device=device)
    res = engine.run(reqs)
    occ = [r["active"] for r in res.step_log]
    print(f"continuous: {len(reqs)} requests, {res.tokens} tokens in "
          f"{res.decode_steps} decode steps / {res.wall_s:.2f}s "
          f"({res.tok_per_s:.0f} tok/s on {engine.device}; occupancy "
          f"{min(occ)}..{max(occ)} of {batch} slots)")
    if moe:
        print(f"dispatch wire: {res.wire_bytes / 1e3:.1f} kB modeled; plan "
              f"swaps: {[(s['step'], s['reason'], s['signature']) for s in res.swap_log]}")
    else:
        print("dispatch wire: none (a dense model has no expert dispatch "
              "to plan); plan swaps: []")
    if res.latency:
        lat = res.latency
        print("latency (decode-step units): "
              f"ttft p50={lat['ttft']['p50']:.1f} "
              f"p99={lat['ttft']['p99']:.1f}; "
              f"tpot p50={lat['tpot']['p50']:.2f}; "
              f"e2e p99={lat['e2e']['p99']:.1f}")
    if slo is not None and obs is not None and obs.metrics_on:
        # res.health only carries verdicts when the registry was live
        misses = [(e.severity, e.subject) for e in res.health]
        print(f"SLO targets {slo.slo_targets()}: "
              + (f"{len(misses)} miss(es) {misses}" if misses
                 else "all attained"))
    # under load shedding a request may leave through the shed list
    # instead of the outputs; every request is accounted for exactly once
    if len(res.outputs) + len(res.shed) != n_req:
        raise SystemExit(f"{len(res.outputs)} served + {len(res.shed)} "
                         f"shed of {n_req} requests")
    if res.shed:
        print(f"load shed: {len(res.shed)} request(s) {sorted(res.shed)}")
    if injector is not None:
        retries = obs.metrics.counter("serve/retries").value if (
            obs is not None and obs.metrics_on) else 0
        print("chaos recovery: survived "
              f"{injector.fired_total} injected fault(s), "
              f"tick retries={retries}, shed={len(res.shed)}")
        if injector.fired_total == 0:
            raise SystemExit("chaos: the plan injected nothing (seed/step "
                             "range mismatch), the smoke proved nothing")
    else:
        print("all requests completed: OK")
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="a smaller model (lm-100m at 2 layers, serve-demo "
                         "at 2 layers and d = 128) and fewer tokens")
    ap.add_argument("--model", default="lm-100m",
                    choices=("lm-100m", "serve-demo"),
                    help="lm-100m (dense) or the example's MoE serve-demo")
    ap.add_argument("--batch", type=int, default=8,
                    help="decode slots (continuous) / batch size (static)")
    ap.add_argument("--tokens", type=int, default=None,
                    help="max new tokens per request")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the scheduler")
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="export a Chrome-trace JSON of the run "
                         "(prefill/decode/admit spans, DESIGN.md §10)")
    ap.add_argument("--metrics-out", type=str, default=None, metavar="PATH",
                    help="write the metrics/event JSONL (occupancy and "
                         "queue histograms, latency percentiles)")
    ap.add_argument("--slo-ttft", type=float, default=16.0,
                    help="p99 time-to-first-token target in decode steps "
                         "(DESIGN.md §10.5); misses become ranked "
                         "health/serve_slo events")
    ap.add_argument("--slo-e2e", type=float, default=96.0,
                    help="p99 arrival->retirement target in decode steps")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="chaos smoke (DESIGN.md §12): a seed-derived "
                         "FaultPlan of recoverable serve faults against the "
                         "decode loop (implies --continuous)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    tokens = args.tokens if args.tokens is not None else (
        8 if args.fast else 24)
    chaos = args.chaos is not None
    if chaos:
        args.continuous = True  # the tick retry hook lives in the scheduler
    obs = obs_mod.configure(trace=bool(args.trace),
                            metrics=bool(args.metrics_out) or bool(args.trace)
                            or chaos)
    model, params = build(args.fast, args.model, args.device)
    print(f"model {model.cfg.name}: {model.cfg.num_layers} layers, "
          f"d={model.cfg.d_model}, vocab {model.cfg.vocab_size}, "
          f"{model.cfg.param_count() / 1e6:.1f} M params")
    injector = None
    if chaos:
        from repro_torch.runtime.faults import FaultInjector, FaultPlan

        # recoverable serve classes only: nonfinite and sigterm abort a
        # decode run by design (its state cannot be replayed)
        plan = FaultPlan.chaos(args.chaos, 16,
                               classes=("collective", "straggler", "stall"))
        injector = FaultInjector(plan)
        print(f"chaos plan (seed {args.chaos}): "
              + ", ".join(f"{s.kind}@tick{s.step}" for s in plan.specs))
    if args.continuous:
        slo = ServeConfig(slo_ttft_p99=args.slo_ttft,
                          slo_e2e_p99=args.slo_e2e)
        run_continuous(model, params, args.batch, tokens, obs=obs, slo=slo,
                       injector=injector, device=args.device)
    else:
        run_static(model, params, args.batch, tokens, obs=obs,
                   device=args.device)
    if obs.enabled:
        obs.export(trace_path=args.trace, metrics_path=args.metrics_out)
        if obs.metrics_on:
            print(obs.metrics.summary())
        for p in (args.trace, args.metrics_out):
            if p:
                print(f"obs: wrote {p}")


if __name__ == "__main__":
    main()
