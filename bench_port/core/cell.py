"""Find a cell's pieces by the names in BENCHMARK.json: its workload file,
its configuration file, its driver and family modules, and the reader of
each per-layer metric. Nothing here names a cell, a configuration or a
metric: adding one adds files and entries, not code."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict          # bench_port/workloads/<cell>.json
    config: dict            # bench_port/configs/<config>.json
    end_to_end: List[dict]  # the BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    chips: int


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: the workload file names config {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    return Cell(
        name=name, workload=workload, config=load_json(root / cfg_entry["file"]),
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)],
        chips=int(entry["chips"]))


def module(kind: str, name: str):
    """bench_port.<kind>.<name>: a driver, family or reference module."""
    return importlib.import_module(f"bench_port.{kind}.{name}")


def reader(metric: str) -> Callable:
    """The `read` function of bench_port/metrics/<metric>.py (metric names
    hold dots, so the file is loaded by path)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

