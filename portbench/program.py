"""The system under test: ``repro_torch``'s training step, built from a
cell's files. The only module of the benchmark that imports the port; it
takes from it the step, its state and plan, and the kernels' launch
counters, and checks that what the port builds is what the configuration
file and the traffic mix state."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from portbench.reference.train import family

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims_of(config: dict) -> dict:
    """The port's model numbers as the configuration file states them,
    dtypes as torch dtypes: what the reference is built from."""
    fields = dict(config["port"]["fields"])
    for k in ("dtype", "param_dtype"):
        fields[k] = DTYPES[fields[k]]
    return fields


def settings_of(config: dict, traffic: dict) -> dict:
    """What the reference's training follows: ranks, microbatches, the
    first step, the sync and the optimizer."""
    return {"ranks": traffic["ranks"], "microbatches": traffic["microbatches"],
            "start_step": traffic["start_step"], "sync": traffic["sync"],
            "optimizer": config["train"]}


def _mismatch(what: str, want, got) -> None:
    if want != got:
        raise ValueError(f"the port's {what} is {got!r}, the benchmark's "
                         f"files state {want!r}")


def _kernel_wrappers():
    from repro_torch.kernels.bucket_scatter import ops as scatter
    from repro_torch.kernels.bucket_topk import ops as topk
    from repro_torch.kernels.qsgd_pack import ops as pack
    from repro_torch.kernels.qsgd_unpack import ops as unpack
    return {"bucket_topk": topk.bucket_topk,
            "bucket_scatter": scatter.bucket_scatter,
            "bucket_scatter_sum": scatter.bucket_scatter_sum,
            "qsgd_pack": pack.qsgd_pack,
            "qsgd_unpack": unpack.qsgd_unpack,
            "qsgd_unpack_grouped": unpack.qsgd_unpack_grouped}


class Program:
    """One cell's model, training step and plan on ``device``."""

    def __init__(self, config: dict, traffic: dict, device):
        from repro_torch.models.model import build_model, init_params
        from repro_torch.train import train_step as ts
        from repro_torch.utils.tree import tree_flatten

        port = config["port"]
        mod = importlib.import_module(f"repro_torch.configs.{port['module']}")
        cfg = mod.config(**{k: DTYPES.get(v, v) if isinstance(v, str) else v
                            for k, v in port.get("overrides", {}).items()})
        dims = dims_of(config)
        for key, want in dims.items():
            _mismatch(key, want, getattr(cfg, key))
        for key, published in port["published"].items():
            _mismatch(f"{key} (published {published})", config[published],
                      dims[key])
        tcfg = mod.train_config(microbatches=traffic["microbatches"])
        tcfg = dataclasses.replace(
            tcfg, zero1=traffic["zero1"],
            sync=dataclasses.replace(tcfg.sync, **traffic["sync"]))
        opt, sched = tcfg.optimizer, tcfg.schedule
        _mismatch("optimizer", "adamw", opt.kind)
        _mismatch("schedule", "cosine", sched.kind)
        for key, want in config["train"].items():
            _mismatch(key, want, getattr(opt if hasattr(opt, key) else sched,
                                         key))
        self.cfg, self.tcfg, self.ts = cfg, tcfg, ts
        self.ranks, self.device = traffic["ranks"], torch.device(device)
        self.start_step = traffic["start_step"]
        self.model = build_model(cfg)
        leaves, paths = tree_flatten(init_params(cfg, device="meta"))
        self.leaves = [(p, tuple(t.shape), t.dtype)
                       for p, t in zip(paths, leaves)]
        ref = family(dims).param_shapes(dims)
        _mismatch("weight layout", sorted((p, s, t) for p, (s, t)
                                          in ref.items()), self.leaves)
        self.step_fn, self.plan = ts.build_train_step(
            self.model, tcfg, dp_total=self.ranks, device=self.device,
            lowering=traffic["lowering"])
        self.wrappers = _kernel_wrappers()
        self._flatten = tree_flatten
        if self.device.type == "cuda":
            self.load_kernels()

    @staticmethod
    def load_kernels() -> None:
        """Build the port's CUDA kernels, or load them from the checkout's
        build cache, now: the port does it at its first launch, inside the
        first step, where a build's host work would move when Python's
        collector frees that step's garbage (see ``run.settle``)."""
        from repro_torch.kernels import _build
        _build.lib()

    def init_state(self, params: dict):
        state = self.ts.init_state(self.model, self.tcfg, self.plan,
                                   self.device, params=params)
        return state._replace(step=self.start_step)

    def step(self, state, batch: dict, bits):
        return self.step_fn(state, batch, rand_fn=bits)

    def params(self, state) -> dict:
        leaves, paths = self._flatten(state.params)
        return dict(zip(paths, leaves))

    def first_grad_norms(self, state) -> dict:
        """Each leaf's norm of the gradient the optimizer was handed in
        the one step taken: its first moment / (1 - beta1) (the moments'
        padding columns hold zeros)."""
        leaves, paths = self._flatten(state.opt["mu"])
        scale = 1.0 / (1.0 - self.tcfg.optimizer.beta1)
        sq = torch.stack([m.to(torch.float32).square().sum() for m in leaves])
        return dict(zip(paths, sq.sqrt() * scale))

    def residual_norms(self, state) -> list:
        """Each EF bucket's residual norm, rank by rank, in plan order."""
        res = state.residuals
        norms = [res[b.name].to(torch.float32).flatten(1).norm(dim=1)
                 for b in self.plan.buckets if b.has_residual]
        return torch.stack(norms).tolist()

    def buckets(self) -> list:
        """(rows, cols, carries EF, quantized) of each bucket of the plan."""
        s = self.tcfg.sync
        return [(b.rows, b.cols, b.has_residual,
                 b.has_residual and bool(s.qsgd_bits)
                 and b.algorithm == "dsar_split_allgather")
                for b in self.plan.buckets]

    def launches(self) -> dict:
        return {n: w.launches for n, w in self.wrappers.items()}

    def reset_launches(self) -> None:
        for w in self.wrappers.values():
            w.launches = 0

    def probes(self, state, batch: dict, bits) -> dict:
        """The step's two halves alone, on ``state`` and ``batch``: the
        ranks' gradients, and the reduce half on one such call's
        gradients and the state's residuals."""
        ts, n_micro = self.ts, self.tcfg.microbatches

        def grads():
            return ts.rank_grads(self.model, state.params, batch, self.ranks,
                                 n_micro)

        held = {}

        def reduce():
            if "leaves" not in held:
                held["leaves"] = grads()[1]
            return ts.reduce_half(self.plan, held["leaves"], state.residuals,
                                  None, bits)

        return {"rank_grads": grads, "reduce_half": reduce}

