"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the card(s) the cell asks for.

Set-up (counted in ``setup_s``, from process start): the port and the
kernels' build or cache load, the weights made on the device from the
seed, the plan and the state, then the cell's first steps, which warm
every shape up and which the reference later follows. The window then
dispatches steps back to back on the state those steps left, each on a
fresh batch and fresh rounding bits, until ``--seconds`` have passed on
the host clock, and ends with a synchronise.

``--trace 0`` reports the end-to-end metrics: ``tokens_per_s`` (the
tokens of every step launched in the window over the window's time) and
``setup_s``. ``--trace 1`` runs the same window under
``torch.profiler`` and reports the per-layer metrics, each read by its
own reader in ``metrics/``; after the window the step's two halves are
timed alone (``probes``).

Then the program's state is freed and the plain reference follows the
first steps on the same inputs; ``check.py``'s numbers against the
cell's limits decide ``correct``. Standard error ends with those numbers,
and the result line carries them last under ``checks``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The JAX modules (and the JAX package) among ``names`` (this
    process's modules by default), compared by whole top-level names."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader may read: this card's trace and
    its validity, the port kernels' launches in the window, the steps,
    the allocator's peak of allocated bytes (``peak_bytes``), the FLOPs this card does a step, the four SparCML kernels' bytes a
    step (None where the count is not made), and the step's halves alone
    (``probe_ms``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def probe_ms(self, name: str):
        fn = self.probes.get(name)
        if fn is None:
            return None
        import torch
        from portbench.measure import time_ms
        return time_ms(torch, fn)


def read_metric(name: str, ctx: Context):
    path = spec.metric_file(name)
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def settle() -> None:
    """A full collection, then every object that survives it set aside
    (``gc.freeze``). The port's step leaves reference cycles that hold
    device tensors until Python's collector frees them, and the collector's
    full passes come when the objects made since the last one outnumber a
    quarter of those that survived it. Set aside, the process's history
    (imports, a kernel build, a profiler) no longer decides when they come:
    the steps that follow see a collector that knows only what they made."""
    gc.unfreeze()
    gc.collect()
    gc.freeze()
    gc.collect()


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """A cell's program on ``device`` with its inputs from ``seed``: the
    state built from the benchmark's weights and driven through the
    cell's first steps (``first``: what the reference is compared on),
    and the reference's readings of the same steps."""

    def __init__(self, cell: spec.Cell, seed: int, device,
                 steps: bool = True):
        import torch

        from portbench import feed
        from portbench.program import Program, dims_of

        self.cell, self.seed = cell, seed
        self.device = device = torch.device(device)
        traffic, config = cell.traffic, cell.config
        self.prog = prog = Program(config, traffic, device)
        self.dims = dims_of(config)
        self.ranks, start = traffic["ranks"], traffic["start_step"]
        checks = traffic["check_steps"]
        self.tokens = feed.Tokens(traffic, self.dims["vocab_size"], seed,
                                  device)
        self.step = start + checks
        if not steps:           # the reference's inputs alone
            self.state = None
            return
        # every set-up step, and the window, start from ``settle``
        settle()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.state = prog.init_state(feed.nest(self.weights()))
        first = {"losses": []}
        for i in range(checks):
            settle()
            self.state, m = prog.step(self.state, self.tokens.batch(start + i),
                                      self.bits(start + i))
            first["losses"].append(m["loss"])
            if i == 0:
                first["grad_norms"] = prog.first_grad_norms(self.state)
                residuals = prog.residual_norms(self.state)
        w0 = self.weights()
        now = prog.params(self.state)
        first["change_norms"] = {
            p: (now[p].to(torch.float32) - w0[p].to(torch.float32)).norm()
            for p in now}
        del w0, now
        self.first = {k: ([float(x) for x in v] if isinstance(v, list)
                          else {p: float(x) for p, x in v.items()})
                      for k, v in first.items()}
        self.first["residual_norms"] = residuals
        gc.unfreeze()

    def weights(self) -> dict:
        from portbench import feed
        return feed.weights(self.seed, self.prog.leaves,
                            self.cell.config["init"], self.device)

    def bits(self, step: int):
        from portbench import feed
        return feed.Bits(self.seed, step, self.device, self.ranks)

    def free(self) -> None:
        """Drop the program's state (the reference runs after it)."""
        import torch
        self.state = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec=None, fault=None) -> dict:
        from portbench.program import settings_of
        from portbench.reference import train as reference
        traffic = self.cell.traffic
        return reference.run(self.dims, settings_of(self.cell.config, traffic),
                             self.weights(), self.tokens.batch, self.bits,
                             steps=traffic["check_steps"], prec=prec,
                             fault=fault)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float = T0) -> dict:
    """One run of ``cell``: the result line as a dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import check, counts, measure

    run = Run(cell, seed, device)
    prog, tokens, state, step = run.prog, run.tokens, run.state, run.step
    run.state = None            # the window's steps replace it
    device, traffic, ranks = run.device, cell.traffic, run.ranks
    cuda = device.type == "cuda"
    bits = run.bits
    batch_tokens = traffic["global_batch"] * traffic["seq_len"]
    losses = []
    settle()
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if trace else None)
    if prof is not None:
        prof.__enter__()
    _sync(torch, device)
    prog.reset_launches()
    alloc0 = torch.cuda.memory_stats(device) if cuda else {}
    dispatched, peaks = [], []
    t_win = time.perf_counter()
    with record_function(measure.WINDOW):
        if trace and cuda:
            torch.cuda._sleep(20_000_000)          # the trace's marker
        while True:
            with record_function("bench.batch"):
                batch, step_bits = tokens.batch(step), bits(step)
            with record_function("bench.step"):
                state, m = prog.step(state, batch, step_bits)
            losses.append(m["loss"])
            step += 1
            dispatched.append(time.perf_counter() - t_win)
            if cuda:        # the allocator's own count: no synchronise
                peaks.append(torch.cuda.max_memory_allocated(device))
            if dispatched[-1] >= seconds:
                break
        with record_function("bench.sync"):
            _sync(torch, device)
    t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = prog.launches()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = sum(not math.isfinite(float(x)) for x in losses)
    n = len(losses)
    alloc1 = torch.cuda.memory_stats(device) if cuda else {}
    card = {"launches_in_window": launches, "steps": n,
            "memory_peak_bytes": int(peak),
            "dispatched_at_s": dispatched, "window_end_s": t_end - t_win,
            "peak_rises": [[i, b] for i, b in enumerate(peaks)
                           if i == 0 or b > peaks[i - 1] + 2**20],
            "allocator_in_window": {
                k: alloc1.get(k, 0) - alloc0.get(k, 0) for k in (
                    "num_alloc_retries", "num_device_alloc",
                    "num_device_free", "num_sync_all_streams")},
            "loadavg": os.getloadavg()}
    out_metrics: dict = {}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else device.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        tr = measure.read_trace(prof)
        valid = tr.valid(launches)
        ctx = Context(
            trace=tr, trace_valid=valid, launches=launches, steps=n,
            peak_bytes=peak,
            flops_per_step=counts.step_flops(run.dims, traffic),
            sync_bytes=counts.sync_bytes(prog.buckets(), ranks,
                                         traffic["sync"]),
            probes=(prog.probes(state, tokens.batch(step), bits(step))
                    if cuda else {}))
        layer = {m_["name"]: read_metric(m_["name"], ctx)
                 for m_ in cell.per_layer}
        card.update(trace_valid=valid, port_kernels_in_trace=tr.port_found,
                    window_s=tr.window_s, busy_s=tr.busy_s, per_layer=layer)
        out_metrics = {m_["name"]: {"value": layer[m_["name"]],
                                    "unit": m_["unit"]}
                       for m_ in cell.per_layer
                       if layer[m_["name"]] is not None}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        del ctx, tr, prof
    else:
        e2e = {"tokens_per_s": n * batch_tokens / (t_end - t_win),
               "setup_s": t_win - t0}
        out_metrics = {m_["name"]: {"value": e2e[m_["name"]],
                                    "unit": m_["unit"]}
                       for m_ in cell.end_to_end}
    del state, m, losses, prog
    run.free()
    print(json.dumps(card), flush=True)
    if cuda:
        print(json.dumps({"card": measure.card_line()}), flush=True)

    # the reference follows the first steps on the same inputs
    ref = run.reference()
    values = check.numbers(run.first, ref)
    print(json.dumps({"numbers": values,
                      "details": check.details(run.first, ref)}), flush=True)
    correct = check.verdict(values, cell.limits)
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": out_metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": values[k], "limit": lim}
                        for k, lim in cell.limits.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for key, value in cell.traffic.get("env", {}).items():
        os.environ[key] = value
    src = str(spec.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), this machine has {have}", file=sys.stderr)
        return 2
    if cell.chips != 1:
        print(f"portbench: {args.workload} asks for {cell.chips} cards; the "
              "harness runs one-card cells only", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}: the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    from portbench import check
    for line in check.report(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
