"""The benchmark is driven by data: every cell, configuration, traffic mix,
limit and per-layer metric is found by its name, and BENCHMARK.json keeps
to the contract's shape."""
import importlib.util
import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (spec.ROOT / p).is_dir()
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.cell(cell)
    assert c.chips in (1, 4)
    assert c.traffic["global_batch"] % (c.traffic["ranks"]
                                        * c.traffic["microbatches"]) == 0
    assert set(c.limits) <= {"loss_gap", "grad_gap", "grad_gap_median",
                             "update_gap", "update_gap_median",
                             "residual_gap", "residual_gap_median"}
    assert all(v > 0 for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "tokens_per_s"}
    assert c.per_layer


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    path = spec.metric_file(metric)
    mod_spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    assert callable(mod.read)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = json.loads((spec.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    for key in conf["reduced"]:
        assert key in data["reduced_from"]
        assert data[key] != data["reduced_from"][key]
    port = data["port"]
    for key, published in port["published"].items():
        assert port["fields"][key] == data[published], key
    assert data["assumed"] and data["deployment"]


def test_metric_workloads_are_cells():
    """A per-layer metric's ``workloads`` names cells of the benchmark
    that report the end-to-end metric it moves; every cell reports
    ``setup_s``, another end-to-end metric and a per-layer metric."""
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
        for name in m.get("workloads", cells):
            assert m["moves"] in {e["name"] for e in spec.cell(name).end_to_end}
    for name in cells:
        c = spec.cell(name)
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_without_a_trace_reads_nothing(metric):
    """With no trace and no probes a reader returns None, never 0."""
    from portbench.run import Context, read_metric
    ctx = Context(trace=None, trace_valid=False, launches={}, steps=0,
                  peak_bytes=0, flops_per_step=1.0, sync_bytes={}, probes={})
    assert read_metric(metric, ctx) is None
