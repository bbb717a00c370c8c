"""BENCHMARK.json against the benchmark's contract, and every cell's pieces
found by name."""
import json
import re

import pytest

from bench_port.core import cell as cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["bench_port"]
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for name in CELLS:
        c = cells.resolve(name)
        assert len(c.end_to_end) >= 2 and c.per_layer, name
    for m in BENCH["per_layer"]:
        reporters = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(reporters), m["name"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    c = cells.resolve(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert entry["chips"] == c.chips == 1 and entry["traffic"] == name
    assert c.workload["config"] == entry["config"] == c.config["name"]
    cells.module("drivers", c.workload["driver"])
    fam = cells.module("families", c.config["family"])
    assert (cells.ROOT / c.config["reference"]).exists()
    assert callable(fam.param_spec)
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))
    cfg_entry = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert set(cfg_entry["reduced"]) == set(c.config["reduced"])
    assert all(k in c.config for k in cfg_entry["reduced"])


def test_harness_holds_no_cell_config_or_metric_name():
    words = set(CELLS) | {c["name"] for c in BENCH["configs"]} \
        | {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = [cells.BENCH_DIR / "run.py", *sorted((cells.BENCH_DIR / "core").glob("*.py")),
             *sorted((cells.BENCH_DIR / "drivers").glob("*.py"))]
    # setup_s and the rate and tail names are the drivers' outputs by kind;
    # only cell, config and per-layer metric names are banned
    banned = words - {m["name"] for m in BENCH["end_to_end"]}
    for f in files:
        text = f.read_text()
        for w in banned:
            assert w not in text, f"{f.name} names {w}"


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    for p in BENCH["paths"]:
        assert (cells.ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    for f in (cells.BENCH_DIR).rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(cells.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
