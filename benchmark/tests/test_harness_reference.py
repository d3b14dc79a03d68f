"""The plain reference against the port's plain versions on the CPU, from
the same initial state and streams; the control and the faults that
``correct`` must fail; and a cell added as a file alone.

The cells run here at their configurations' widths, with the traffic cut
to what a CPU test holds (2-step chunks, a short window, a subset of the
rows) by workload files the tests write into a copy of the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import compare, harness, reference
from benchmark.run import first_steps, reference_records

REPO = Path(__file__).resolve().parents[2]
SPHERE_ROWS = {"rows": [[3, 3, 6], [5, 16, 16]], "dataset_seeds": [69, 24]}
LINEAR_ROWS = {"rows": [[3, 9, 20], [12, 8, 10]], "dataset_seeds": [2, 3]}
# the solo kind: one Trainer of sphere row 1 on K5; no cell of
# BENCHMARK.json runs it (its float8 control reads under 3x the program
# on every number), so only its agreement with the plain version is held
SOLO = dict(harness.load("workloads", "sphere_sweep.chunks"), kind="solo", rows=[[3, 3, 6]],
            dataset_seeds=[69], kernel="K5")
TEST_CELLS = {  # cell → (workload, traffic cut for the CPU)
    "sphere_sweep.chunks": dict(SPHERE_ROWS, chunk_steps=2),
    "linear_sweep.chunks": dict(LINEAR_ROWS, chunk_steps=2),
    "sphere_sweep.cadence": dict(SPHERE_ROWS, chunk_steps=2, n_print=3, n_plot=6),
    "sphere_sweep.row1_solo": dict(SOLO, chunk_steps=2),
}


def first_step_limits(w):
    """The cell's limits on its first steps (what it wrote to disk is
    judged by a whole run: ``ckpt_mismatch``)."""
    return {k: v for k, v in w["limits"].items() if k != "ckpt_mismatch"}


def workload(cell):
    if cell == "sphere_sweep.row1_solo":
        return TEST_CELLS[cell]
    return dict(harness.load("workloads", cell), **TEST_CELLS[cell])


@pytest.mark.parametrize("cell", sorted(TEST_CELLS))
def test_reference_follows_the_plain_versions(cell):
    w = workload(cell)
    config = harness.load("configs", w["config"])
    _, rows, init, records = first_steps(config, w, 2_147_483_999, "cpu")
    got = compare.readings(records, reference_records(rows, init, config, "eval" in records))
    # the same float32 arithmetic in another order: rounding only
    assert all(v < 1e-5 for v in got.values()), got
    assert set(first_step_limits(w)) <= set(got)


CELLS = sorted(c for c in TEST_CELLS if c != "sphere_sweep.row1_solo")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("variant", ["control", "half_batch", "frozen", "stale"])
def test_control_and_faults_fail_the_limits(cell, variant):
    """The reference put in the program's place, in float8 products (the
    control) or with a fault (``stale``: the last checked step on the
    draws of the one before, as a launch that reused its first step's
    data and noise), is not correct by the cell's limits."""
    w = workload(cell)
    config = harness.load("configs", w["config"])
    cell_obj = harness.Cell(config, w, 5, "cpu")
    rows = cell_obj.ref_rows()
    init = reference.make_init(rows, 5, "cpu")
    with_eval = w["kind"] == "cadence"
    ref = reference_records(rows, init, config, with_eval)
    kw = {"control": {"rnd": reference.fp8_round}, "half_batch": {"half_batch": True},
          "frozen": {"frozen": True}, "stale": {"stale": True}}[variant]
    got = compare.readings(reference_records(rows, init, config, with_eval, **kw), ref)
    assert set(got) == set(first_step_limits(w))
    assert not compare.judge(got, first_step_limits(w)), got


def checkout(tmp_path: Path, cells: dict) -> Path:
    """A copy of BENCHMARK.json and benchmark/ with the given workload
    files written into it (and their cells added where new)."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]}
    for name, (config, traffic, data) in cells.items():
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(data))
        if name not in names:
            bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                       "chips": 1, "why": "a cell added by a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cpu_run(root: Path, cell: str, fault: str = "") -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    cmd = [sys.executable, "benchmark/tests/_cpu_run.py", cell, "1234567891", "0.3"]
    out = subprocess.run(cmd + (["--fault", fault] if fault else []), cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS + ["sphere_sweep.row1_solo"])
def test_a_run_with_its_timed_path_broken_is_not_correct(tmp_path, cell):
    """Each kind driven through a whole run on the CPU: correct as it is,
    not correct with its timed path broken underneath (and, where the
    cell's loop saves, with the saves left unwritten)."""
    w = workload(cell)
    root = checkout(tmp_path, {cell: (w["config"], cell.split(".", 1)[1], w)})
    sound = cpu_run(root, cell)
    assert sound["correct"] is True, sound["checks"]
    assert sound["metrics"]["row_steps_per_s"]["value"] > 0
    faults = ["frozen", "half_batch", "altered"]
    if w["kind"] == "cadence":
        assert sound["checks"]["ckpt_mismatch"] == {"value": 0, "limit": 0}
        faults.append("unsaved")
    for fault in faults:
        result = cpu_run(root, cell, fault)
        assert result["correct"] is False, (fault, result["checks"])


def test_a_cell_added_as_a_file_runs(tmp_path):
    data = dict(harness.load("workloads", "sphere_sweep.chunks"), rows=[[7, 7, 13]],
                dataset_seeds=[48], chunk_steps=3)
    root = checkout(tmp_path, {"sphere_sweep.row5": ("sphere_sweep", "row5", data)})
    result = cpu_run(root, "sphere_sweep.row5")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"row_steps_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
