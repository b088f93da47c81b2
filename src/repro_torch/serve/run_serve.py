"""Serve the LM with greedy decoding on one GPU.

    PYTHONPATH=src python -m repro_torch.serve.run_serve     # static batch
    PYTHONPATH=src python -m repro_torch.serve.run_serve --continuous
    PYTHONPATH=src python -m repro_torch.serve.run_serve --fast --continuous
    PYTHONPATH=src python -m repro_torch.serve.run_serve --chaos 0 \
        --trace t.json --metrics-out m.jsonl

The PyTorch counterpart of ``examples/serve_decode.py``. The example
serves its MoE "serve-demo" model, whose family the port does not have
yet (``--model serve-demo`` raises, naming ROADMAP Queue 1 item 12); this
script serves lm-100m (``run_lm.lm_config``: 12 layers, d = 768, GQA 12/4
heads, SwiGLU 2048, vocab 32768, f32, random weights from seed 0), and
under ``--fast`` the same widths at 2 layers. The requests are the
example's: the static run decodes ``--batch`` prompts of 16 tokens; the
continuous run (``--continuous``) serves 2 x ``--batch`` requests with
Poisson arrivals at 0.5 a decode step (seed 0), prompts of 4 to 19 tokens
and ``--tokens`` / 2 to ``--tokens`` new tokens each, over ``--batch``
slots with a cache of 128. It prints tok/s, occupancy, the latency
percentiles (decode steps), the SLO verdicts of ``--slo-ttft`` and
``--slo-e2e``, and the shed and retried counts. ``--chaos SEED`` (implies
``--continuous``) injects a seed-derived plan of recoverable serve faults
(a collective raise, a straggler, a stall) before decode ticks; the run
must complete through the tick retries, and exits non-zero when the plan
injected nothing. ``--trace`` exports a Chrome trace of the prefill,
admission and decode spans, ``--metrics-out`` the metrics JSONL. The
dense family has no activation exchange to plan, so, as in the example
on such a model, no plan swap happens and no serve-plan audit runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.models.model import build_model
from repro_torch.serve import (ContinuousServeEngine, Request, ServeConfig,
                               ServeEngine, poisson_trace)
from repro_torch.train import run_lm

CACHE_LEN = 128


def build(fast: bool, model: str = "lm-100m", device="cuda"):
    """(model, params): lm-100m, at 2 layers under ``fast``."""
    if model != "lm-100m":
        raise NotImplementedError(
            f"model {model!r}: the example's serve-demo is a MoE model, and "
            "the MoE family is not ported yet (ROADMAP Queue 1 item 12)")
    cfg, _ = run_lm.lm_config(fast=False)
    if fast:
        cfg = dataclasses.replace(cfg, name="lm-100m-2l", num_layers=2)
    m = build_model(cfg)
    return m, m.init(torch.Generator().manual_seed(0), device=device)


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
    engine = ContinuousServeEngine(model, params, cache_len=CACHE_LEN,
                                   batch_size=batch, dispatch="adaptive",
                                   obs=obs, serve_cfg=slo, injector=injector,
                                   device=device)
    res = engine.run(reqs)
    occ = [r["active"] for r in res.step_log]
    print(f"continuous: {len(reqs)} requests, {res.tokens} tokens in "
          f"{res.decode_steps} decode steps / {res.wall_s:.2f}s "
          f"({res.tok_per_s:.0f} tok/s on {engine.device}; occupancy "
          f"{min(occ)}..{max(occ)} of {batch} slots)")
    print("dispatch wire: none (a dense model has no expert dispatch to "
          "plan); plan swaps: []")
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
                    help="lm-100m at 2 layers and fewer tokens")
    ap.add_argument("--model", default="lm-100m",
                    choices=("lm-100m", "serve-demo"),
                    help="serve-demo is the example's MoE model (raises: "
                         "ROADMAP Queue 1 item 12)")
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
