"""A whole run at a size the CPU holds: the result line's shape, the plain
reference against the port (bit-near in float32), the reference's buckets
against the port's plan, the inputs from the seed, and the refusal to run
without the program."""
import json
import math
import subprocess
import sys

import pytest
import torch

from portbench import check, feed, spec
from portbench.program import Program
from portbench.reference.sync import Layout
from portbench.run import Run, run_cell
from portbench.tests import tiny
from portbench.tests.tiny import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CELLS = list(tiny.CELLS)


def _run(cell, **kw):
    return run_cell(cell, 2**33 + 7, 0.2, False, device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    cell = tiny.cell(name)
    out = _run(cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and math.isfinite(got["value"])
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.limits)
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port(name):
    """In float32 the port and the reference differ by rounding alone."""
    run = Run(tiny.cell(name), 5, "cpu")
    run.free()
    values = check.numbers(run.first, run.reference())
    assert max(values.values()) < 1e-5, values


@pytest.mark.parametrize("name", CELLS)
def test_layout_is_the_plan(name):
    """The reference's buckets are the port's plan's, tiny and full size."""
    for cell in (tiny.cell(name), spec.cell(name)):
        prog = Program(cell.config, cell.traffic, "cpu")
        lay = Layout({p: s for p, s, _ in prog.leaves}, cell.traffic["sync"],
                     cell.traffic["ranks"])
        assert [(b.rows, b.cols, b.has_residual)
                for b in prog.plan.buckets] == [
            (b.rows, b.cols, b.sparse) for b in lay.buckets]
        assert any(b.sparse for b in lay.buckets)


def test_inputs_repeat_from_the_seed():
    tr = spec.cell("moonshot-sparcml-r2").traffic
    a, b = (feed.Tokens(tr, 1000, 2**40 + 3, "cpu").batch(5) for _ in "ab")
    assert torch.equal(a["tokens"], b["tokens"])
    rows = a["tokens"]
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    bits = feed.Bits(2**40 + 3, 5, "cpu", 2)
    both = bits(7, 64).view(torch.int32)
    assert torch.equal(both[32:], bits.rank_fn(1)(7, 32).view(torch.int32))
    leaves = [(("w",), (4, 3), torch.bfloat16), (("scale",), (3,),
                                                torch.bfloat16)]
    w1 = feed.weights(11, leaves, {"scale": "ones"}, "cpu")
    w2 = feed.weights(11, leaves, {"scale": "ones"}, "cpu")
    assert torch.equal(w1[("w",)], w2[("w",)])
    assert torch.equal(w1[("scale",)], torch.ones(3, dtype=torch.bfloat16))


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run exits non-zero and prints no result."""
    (tmp_path / "BENCHMARK.json").write_text(
        (spec.ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(spec.HERE), str(tmp_path / "portbench")],
                   check=True)
    cell = spec.benchmark()["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_refuses_a_cell_of_more_cards(monkeypatch, capsys):
    """The harness runs one-card cells; a cell that asks for four cards
    exits non-zero before any work and prints no result."""
    import dataclasses

    from portbench import run

    four = dataclasses.replace(spec.cell("moonshot-sparcml-r2"), chips=4)
    monkeypatch.setattr(spec, "cell", lambda name: four)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: pytest.fail("ran"))
    monkeypatch.setattr(run.os, "environ", dict(run.os.environ))
    assert run.main(["--workload", "x", "--seed", "1", "--seconds", "1"]) == 2
    assert '"correct"' not in capsys.readouterr().out
