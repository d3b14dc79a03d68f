"""Nothing the benchmark loads is JAX or the JAX package; the reference
loads nothing of the program; the harness refuses to run without a card
or without the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.imports import forbidden_loaded

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names,bad", [
    (["vae_training_tpu_torch", "vae_training_tpu_torch.kernels.mlp_vae"], []),
    (["vae_training_tpu.models"], ["vae_training_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_helpers", "flaxen", "numpy"], []),
])
def test_forbidden_names_are_whole_top_level_names(names, bad):
    assert forbidden_loaded(names) == bad


def loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return {n.split(".", 1)[0] for n in json.loads(out.stdout.strip().splitlines()[-1])}


def test_the_reference_loads_neither_jax_nor_the_program():
    tops = loaded("import benchmark.reference, benchmark.compare, benchmark.counts")
    assert not forbidden_loaded(tops)
    assert "vae_training_tpu_torch" not in tops


def test_a_cpu_run_loads_no_jax():
    code = ("import contextlib, sys\n"
            "from benchmark import harness, run\n"
            "w = dict(harness.load('workloads', 'sphere_sweep.cadence'), rows=[[3, 3, 6]],\n"
            "         dataset_seeds=[69], n_print=2, n_plot=4, chunk_steps=2)\n"
            "c = harness.load('configs', 'sphere_sweep')\n"
            "with contextlib.redirect_stdout(sys.stderr):\n"
            "    cell, rows, init, rec = run.first_steps(c, w, 7, 'cpu')\n"
            "    cell.warm(); cell.window(0.2); cell.close()\n")
    tops = loaded(code)
    assert "vae_training_tpu_torch" in tops
    assert not forbidden_loaded(tops)


def run_cell(cwd: Path, pythonpath: str):
    env = dict(os.environ, PYTHONPATH=pythonpath, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "sphere_sweep.chunks", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    out = run_cell(REPO, str(REPO))
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["benchmark"]
    out = run_cell(tmp_path, str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("imported", ["", "jax"])
def test_a_module_loaded_after_the_window_withholds_the_result(tmp_path, imported):
    """A per-layer reader that loads a module named ``jax`` (a stub here)
    after the window's own check: the run prints no result."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "workloads" / "sphere_sweep.tiny.json").write_text(json.dumps(dict(
        json.loads((REPO / "benchmark" / "workloads" / "sphere_sweep.chunks.json").read_text()),
        rows=[[3, 3, 6]], dataset_seeds=[69], chunk_steps=2)))
    (root / "benchmark" / "metrics" / "probe.py").write_text(
        (f"import {imported}  # noqa: F401\n" if imported else "") + "def read(run):\n"
        "    return 1.0\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sphere_sweep.tiny", "config": "sphere_sweep",
                               "traffic": "tiny", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "probe", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "row_steps_per_s", "workloads": ["sphere_sweep.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(tmp_path / "stub"), str(root), str(REPO)]))
    out = subprocess.run([sys.executable, "benchmark/tests/_cpu_run.py", "sphere_sweep.tiny",
                          "99", "0.2", "--trace", "1"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if imported:
        assert out.returncode != 0 and out.stdout == "", out.stdout[-2000:]
        assert "forbidden modules loaded: jax" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["metrics"]["probe"]["value"] == 1
