"""What a cell is, read from data: ``BENCHMARK.json`` names the cell's
configuration, traffic mix and chips; the configuration's file, the
traffic mix's file (``traffic/<name>.json``) and the cell's limits
(``limits/<cell>.json``) give the rest. Pure JSON: nothing here imports
torch, so the harness can set the allocator's environment first."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file, as JSON
    traffic_name: str
    traffic: dict         # traffic/<name>.json
    limits: dict          # limits/<cell>.json: number -> limit
    end_to_end: tuple     # BENCHMARK.json entries this cell reports
    per_layer: tuple


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files read."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_load(root / conf["file"]), traffic_name=w["traffic"],
        traffic=_load(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_load(HERE / "limits" / f"{name}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)))


def metric_file(name: str) -> Path:
    """The reader of per-layer metric ``name``."""
    return HERE / "metrics" / f"{name}.py"
