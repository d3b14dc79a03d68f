"""Run one benchmark cell of vae_training_tpu_torch once on the GPU.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its traffic is
``benchmark/workloads/<cell>.json``, its configuration
``benchmark/configs/<config>.json``, and each per-layer metric a reader
``benchmark/metrics/<metric>.py``. Everything the program prints goes to
standard error; the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), then ``checks``, every number compared
beside its limit. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace of the
window.

Set-up (``setup_s``) runs from the process's start to the first timed step:
imports, the CUDA context, loading the kernels' libraries (or building
them, in a checkout's first run: ``compile_s`` says how long), the rows'
datasets and trainers, the initial parameters, the first steps that
``correct`` checks and one warm-up chunk. The window then runs chunks
until ``--seconds`` have passed and closes at the next chunk boundary.
After it, the checkpoints a ``cadence`` window's saves wrote are read back,
the plain reference (``reference.py``) replays the first steps and
``compare.py`` decides ``correct``. The result is withheld (no line, a
non-zero exit) where JAX, its runtime, flax or the JAX package is loaded
after the window or when the line is due.
"""

from __future__ import annotations

import time

_T_LOADED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import imports  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
EVAL_COUNTER = 2  # the banner draws at counter 1, the first eval at 2


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_LOADED


def cache_dirs() -> None:
    """Every cache the program or its libraries might keep, at fixed paths
    inside the checkout (the kernels' own is ``build/kernels/``)."""
    build = REPO / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The ``section`` metrics (``end_to_end`` or ``per_layer``) the cell
    reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m and m["moves"] in names)]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def off_path_calls(kernel: str, counts: dict, on_card: bool) -> int:
    """Calls outside the cell's kernel, plus one when the kernel never
    launched; on the CPU, where the plain versions stand in, none."""
    if not on_card:
        return 0
    return sum(v for k, v in counts.items() if k != kernel) + (counts.get(kernel, 0) == 0)


def first_steps(config: dict, workload: dict, seed: int, device: str, marks: dict = None):
    """The cell's program object built, given the initial parameters the
    seed draws, and driven through the first steps: (cell, the reference's
    rows, the initial parameters, the program's records). ``marks`` gets
    the process's age at the end of each part."""
    from . import harness, reference

    marks = {} if marks is None else marks
    marks["imports"] = process_age()
    cell = harness.build(config, workload, seed, device)
    marks["build"] = process_age()
    rows = cell.ref_rows()
    init = reference.make_init(rows, seed, device)
    cell.hand_init(init)
    records = cell.first_steps(init)
    marks["first_steps"] = process_age()
    return cell, rows, init, records


def reference_records(rows, init, config: dict, with_eval: bool, **variant) -> dict:
    """The plain reference's records of the same first steps (and the first
    eval where the cell checks one); ``variant`` (``rnd``, ``half_batch``,
    ``frozen``) makes the control or a fault."""
    import torch

    from . import harness, reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = {"loss": [], "g1": [], "delta": []}
    for row, p0 in zip(rows, init):
        out = reference.train(row, p0, harness.FIRST_STEPS, **variant)
        for k in ref:
            ref[k].append({n: t.cpu() for n, t in out[k].items()} if k != "loss" else out[k])
    if with_eval:
        ev = {k: v for k, v in variant.items() if k not in ("frozen", "stale")}
        ref["eval"] = [reference.evaluate(row, p0, EVAL_COUNTER, config["epsilon"], **ev)
                       for row, p0 in zip(rows, init)]
    return ref


def measure(args, bench: dict, device: str) -> dict:
    """Set-up, the window, the reference and the comparison; returns the
    result line, or None after naming a forbidden module."""
    import torch

    from . import compare, harness
    from . import trace as tracing

    workload = harness.load("workloads", args.workload)
    config = harness.load("configs", workload["config"])
    marks = {}
    cell, rows, init, records = first_steps(config, workload, args.seed, device, marks)
    cell.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = process_age()
    from vae_training_tpu_torch.kernels import _build

    compile_s = sum(rec["seconds"] for _, rec in _build._LOADED.values() if rec["built"])
    ends = ", ".join(f"{k} {v:.3f}s" for k, v in marks.items())
    log(f"[bench] set-up {setup_s:.3f}s (nvcc {compile_s:.3f}s of it; ends of its parts: "
        f"{ends}, warm-up {setup_s:.3f}s)")

    trace = None
    if args.trace:
        window_s, trace = tracing.profiled(lambda: cell.window(args.seconds))
    else:
        window_s = cell.window(args.seconds)
    rate = cell.row_steps / window_s
    counts = harness.counters()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    spans = cell.spans
    n_chunks = len(spans.spans["chunk"])
    launch_steps, row_shapes = cell.launch_steps, [(dd + pd, ld) for dd, pd, ld, _ in cell.rows]
    saved = cell.saved(init)
    cell.close()
    bad = imports.forbidden_loaded()
    if bad:
        log(f"[bench] forbidden modules loaded: {', '.join(bad)}")
        return None
    log(f"[bench] window {window_s:.3f}s, {cell.row_steps} row-steps in {n_chunks} chunks, "
        f"{rate:.3f} row-steps/s; counters {counts}; eval rounds (s) {spans.rounds('eval')}; "
        f"save stalls (s) {spans.rounds('save')}")
    del cell
    gc.collect()

    # the plain reference, after the window and the memory reading
    numbers = compare.readings(records, reference_records(rows, init, config, "eval" in records))
    numbers.update(saved)
    numbers["off_path_calls"] = off_path_calls(workload["kernel"], counts, device == "cuda")
    limits = dict(workload["limits"], off_path_calls=0)
    correct = compare.judge(numbers, limits)

    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if trace is None:
        values = {"row_steps_per_s": rate, "setup_s": setup_s}
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        # what the per-layer readers read
        view = SimpleNamespace(config=config, device_name=name, counts=counts, spans=spans,
                               trace=trace, rate=rate, launch_steps=launch_steps,
                               launches=n_chunks, row_shapes=row_shapes)
        for m in cell_metrics(bench, args.workload, "per_layer"):
            value = reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    log(f"[bench] card: {card_line()}")
    result = {"correct": correct, "attempted": n_chunks, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compile_s"] = compile_s
    result["setup_warm_s"] = setup_s - compile_s
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k in limits:
        log(f"check {k}: {numbers[k]!r} limit {limits[k]!r}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    specs = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in specs:
        log(f"no cell {args.workload!r}; BENCHMARK.json has {sorted(specs)}")
        return 2
    bad = imports.forbidden_loaded()
    if bad:
        log(f"[bench] forbidden modules loaded at start: {', '.join(bad)}")
        return 3
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < specs[args.workload]["chips"]:
        log(f"[bench] needs {specs[args.workload]['chips']} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count {torch.cuda.device_count()}")
        return 2
    cache_dirs()
    with contextlib.redirect_stdout(sys.stderr):
        result = measure(args, bench, "cuda")
    return emit(result)


def emit(result) -> int:
    """Print the result line as the last of standard output, unless a
    forbidden module is loaded by now (the readers, the reference and the
    comparison run after the window's own check); the exit code."""
    if result is None:
        return 3
    bad = imports.forbidden_loaded()
    if bad:
        log(f"[bench] forbidden modules loaded: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
