"""The readings the limits of ``correct`` are set from, for one cell, over
many seeds in one process (the benchmark's own runs do not run this):

  - ``program``: the cell's timed path through its first steps, against
    the plain reference (as every run of the cell compares);
  - ``control``: the reference in float8 e4m3 products (the nearest
    precision below the configuration's bf16), in the program's place;
  - the faults, planted in the reference put in the program's place:
    ``half_batch`` (the mean over half of each batch), ``frozen`` (a step
    that returns its state unchanged), ``altered`` (one parameter of the
    first row written 0.5 off where the step produces it), ``stale`` (the
    last checked step given the draws of the one before, as a launch that
    reused its first step's data and noise would).

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,13 \\
        [--faults 3] [--out chiprun_out/calibrate_<cell>.json]

Prints, for each number, the largest program reading and the least
control and fault readings, and writes every reading to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from . import compare, harness, reference
from .run import first_steps, log, reference_records


def altered(ref: dict) -> dict:
    """The reference's records with one answer written wrong: the first
    element of row 0's first weight matrix 0.5 off after the steps."""
    delta = [dict(d) for d in ref["delta"]]
    k = next(k for k in delta[0] if k.endswith(".kernel"))
    delta[0][k] = delta[0][k].clone()
    delta[0][k].view(-1)[0] += 0.5
    return dict(ref, delta=delta)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated --seed values")
    p.add_argument("--faults", type=int, default=3,
                   help="how many of the seeds also read the control and the faults")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    workload = harness.load("workloads", args.workload)
    config = harness.load("configs", workload["config"])
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = {"program": [], "control": [], "half_batch": [], "frozen": [], "altered": [],
                "stale": []}
    for n, seed in enumerate(seeds):
        with contextlib.redirect_stdout(sys.stderr):
            cell, rows, init, records = first_steps(config, workload, seed, args.device)
            cell.close()
        del cell
        with_eval = "eval" in records
        ref = reference_records(rows, init, config, with_eval)
        got = {"program": compare.readings(records, ref)}
        if n < args.faults:
            got["control"] = compare.readings(
                reference_records(rows, init, config, with_eval, rnd=reference.fp8_round), ref)
            got["half_batch"] = compare.readings(
                reference_records(rows, init, config, with_eval, half_batch=True), ref)
            frozen = reference_records(rows, init, config, with_eval, frozen=True)
            got["frozen"] = compare.readings(frozen, ref)
            got["altered"] = compare.readings(altered(ref), ref)
            got["stale"] = compare.readings(
                reference_records(rows, init, config, with_eval, stale=True), ref)
        for k, v in got.items():
            readings[k].append(dict(v, seed=seed))
        log(f"seed {seed}: " + "; ".join(f"{k} {v}" for k, v in got.items()))

    names = [k for k in readings["program"][0] if k != "seed"]
    summary = {"program_max": {k: max(r[k] for r in readings["program"]) for k in names}}
    for variant in ("control", "half_batch", "frozen", "altered", "stale"):
        if readings[variant]:
            summary[f"{variant}_min"] = {k: min(r[k] for r in readings[variant]) for k in names}
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "summary": summary, "readings": readings}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
