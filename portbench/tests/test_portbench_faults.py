"""``correct`` comes out false for the control (the reference in fp8 in
the program's place) and for each fault a training cell can have,
planted in the port underneath a whole run of the harness: a step that
returns its state unchanged, half of the batch left out (the mean over
the rest), the exchange between the ranks left out."""
import pytest
import torch

from portbench import check
from portbench.program import Program
from portbench.reference.layers import Prec
from portbench.run import Run, run_cell
from portbench.tests import tiny
from portbench.tests.tiny import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CELLS = list(tiny.CELLS)


def _run(cell):
    return run_cell(cell, 2**33 + 7, 0.2, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in fp8 in the program's place fails the limits."""
    run = Run(tiny.cell(name), 9, "cpu")
    run.free()
    values = check.numbers(run.reference(prec=Prec(fp8=True)),
                           run.reference())
    assert not check.verdict(values, run.cell.limits), values


def _unchanged(monkeypatch):
    real = Program.step
    monkeypatch.setattr(Program, "step", lambda self, state, batch, bits: (
        state, real(self, state, batch, bits)[1]))


def _half_batch(monkeypatch):
    from repro_torch.train import train_step as ts
    real = ts._accumulated_grads

    def half(model, params, batch, n_micro):
        rows = next(iter(batch.values())).shape[0]
        return real(model, params, {k: v[:rows // 2] for k, v in
                                    batch.items()}, max(1, n_micro // 2))
    monkeypatch.setattr(ts, "_accumulated_grads", half)


def _no_exchange(monkeypatch):
    from repro_torch.train import train_step as ts
    real = ts.reduce_half

    def own(plan, leaves, residuals, coll, rand_fn, telemetry=False):
        p = leaves[0].shape[0]
        mine = [torch.cat([g[:1] * p, torch.zeros_like(g[1:])]) for g in leaves]
        return real(plan, mine, residuals, coll, rand_fn, telemetry)
    monkeypatch.setattr(ts, "reduce_half", own)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny.cell("moonshot-sparcml-r2"))
    assert out["correct"] is False, out["checks"]
