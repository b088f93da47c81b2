"""What a step costs, counted from the operations eager PyTorch runs (the
counterpart of the JAX package's ``utils/hlo_cost.py`` and
``utils/hlo_analysis.py``, which parse compiled HLO text).

Eager PyTorch has no HLO and no loop bodies counted once: every aten op
a function runs reaches ``OpCost``, a ``TorchDispatchMode``, which
counts
  * FLOPs with ``torch.utils.flop_counter``'s formulas: the matmuls
    (mm, addmm, bmm, baddbmm, _scaled_mm) as ``flops``, the name the
    reference gives its dot FLOPs, and the registry's other ops
    (convolutions, fused attention) apart as ``other_flops``;
    elementwise ops count no FLOPs, as in the reference;
  * the bytes of each op's tensor operands and results (the reference's
    "operand + result bytes of top-level ops" model). XLA fuses
    elementwise chains and only their boundaries touch memory; eager
    ops are not fused, so here every op's operands and results are
    charged and the count is an upper bound on the bytes a fused step
    moves;
  * the ops run (views excluded: they move nothing) and the largest
    bytes live at once among the tensors the counted ops made
    (``peak_bytes``; tensors made before the mode began, the params and
    the batch, are not among them).

It runs on ``meta`` tensors, so a full-width model costs no memory and
no device. The collective bytes of a step come from the sync plan, not
from parsed text: ``SyncPlan.wire_bytes_by_bucket``. The counterpart of
``remat_duplication`` is the dry run's ``remat_dup``: the counted matmul
FLOPs of a microbatch over the same microbatch's with ``cfg.remat`` off.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.models.model import init_params
from repro_torch.train.train_step import _accumulated_grads

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
            _aten._scaled_mm}


class OpCost(TorchDispatchMode):
    """Counts, while active, the FLOPs, bytes and ops of every aten op
    (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.other_flops = 0
        self.bytes = 0
        self.ops = 0
        self.peak_bytes = 0
        self._live_bytes = 0
        self._live = {}          # storage -> [bytes, tensors holding it]

    def _release(self, key) -> None:
        entry = self._live[key]
        entry[1] -= 1
        if not entry[1]:
            self._live_bytes -= entry[0]
            del self._live[key]

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key not in self._live:
            self._live[key] = [storage.nbytes(), 0]
            self._live_bytes += storage.nbytes()
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        self._live[key][1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._hold(t)
        if func.is_view:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            if packet in _MATMULS:
                self.flops += n
            else:
                self.other_flops += n
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        self.ops += 1
        return out

    def as_dict(self) -> dict:
        return {"flops": self.flops, "other_flops": self.other_flops,
                "bytes": self.bytes, "ops": self.ops,
                "peak_bytes": self.peak_bytes}


def count(fn, *args, **kwargs) -> tuple[OpCost, object]:
    """Run ``fn(*args, **kwargs)`` under an ``OpCost``; returns (the
    counts, fn's result)."""
    with OpCost() as cost:
        out = fn(*args, **kwargs)
    return cost, out


def microbatch_cost(model, batch: dict) -> OpCost:
    """One rank's forward + backward on one microbatch, as the training
    step runs it (``train_step._accumulated_grads``, remat as the
    model's config says), on ``meta`` params: ``batch`` holds meta
    tensors of the microbatch's shapes."""
    params = init_params(model.cfg, device="meta")
    cost, _ = count(_accumulated_grads, model, params, batch, 1)
    return cost

