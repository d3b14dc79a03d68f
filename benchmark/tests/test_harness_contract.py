"""BENCHMARK.json and the files it names: the contract's shapes, names and
units, each metric's reader, and the cells each metric is read in."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def workload_file(cell):
    return json.loads((REPO / "benchmark" / "workloads" / f"{cell}.json").read_text())


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_exactly_their_keys(section, keys):
    entries = BENCH[section]
    assert entries
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert keys <= set(e) <= keys | extra, e
        assert NAME.match(e["name"])
    assert len({e["name"] for e in entries}) == len(entries)


def test_metric_names_units_and_sources():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_configs_are_files_under_paths():
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert TEXT.match(c["source"]) and c["source"].startswith("https://")
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}


def test_cells_and_their_workload_files():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        data = workload_file(w["name"])
        assert data["config"] == w["config"]
        assert data["kind"] in ("chunks", "cadence", "solo")
        assert set(data["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from benchmark.run import cell_metrics

    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        names = {m["name"] for m in cell_metrics(BENCH, w["name"], "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        per_layer = cell_metrics(BENCH, w["name"], "per_layer")
        assert per_layer
        for m in per_layer:
            assert m["moves"] in names
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}


def test_every_per_layer_metric_has_a_reader():
    from benchmark.run import reader

    for m in BENCH["per_layer"]:
        assert callable(reader(m["name"]))


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
