"""Drive one cell's run on the CPU, the chip's look skipped, optionally with
a fault planted in the program's timed path underneath; prints the result
line. Run from the root of a benchmark checkout with the program on
``PYTHONPATH``:

    python benchmark/tests/_cpu_run.py <cell> <seed> <seconds> [--fault F] [--trace 1]

Faults: ``frozen`` (a step returns its state unchanged), ``half_batch``
(the mean over half of each batch), ``altered`` (the first parameter of
the first row written 0.5 off by every chunk), ``unsaved`` (a save
writes no checkpoint). The exit code and the last line are the harness's
own (``run.emit``): no line where it refuses the result.
"""

import contextlib
import json
import os
import sys

sys.path.insert(0, os.getcwd())


def plant(fault: str) -> None:
    import torch

    from vae_training_tpu_torch.kernels import linear_vae, mlp_vae
    from vae_training_tpu_torch.train import grid, step

    if fault == "unsaved":
        grid.save_checkpoint = lambda *a, **kw: None
        return

    def faulty(fn, flat_state):
        def run(*args, **kw):
            if fault == "half_batch":
                kw["batch_size" if "batch_size" in kw else "batch"] //= 2
            saved = [t.clone() for t in flat_state(args)] if fault == "frozen" else None
            out = fn(*args, **kw)
            if saved is not None:
                with torch.no_grad():
                    for t, s in zip(flat_state(args), saved):
                        t.copy_(s)
            if fault == "altered":
                with torch.no_grad():
                    flat_state(args)[0].view(-1)[0] += 0.5
            return out
        run.calls = run.launches = 0
        return run

    for mod in (mlp_vae, linear_vae):
        mod.run_grid_chunk = faulty(mod.run_grid_chunk, lambda a: a[:3])
    step.train_chunk = faulty(
        step.train_chunk,
        lambda a: [t for d in (a[2].params, a[2].m, a[2].v) for t in d.values()])


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("cell")
    p.add_argument("seed", type=int)
    p.add_argument("seconds", type=float)
    p.add_argument("--fault", default="")
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args()
    if args.fault:
        plant(args.fault)
    from benchmark import run

    bench = json.loads(open("BENCHMARK.json").read())
    run_args = argparse.Namespace(workload=args.cell, seed=args.seed, seconds=args.seconds,
                                  trace=args.trace)
    with contextlib.redirect_stdout(sys.stderr):
        result = run.measure(run_args, bench, "cpu")
    return run.emit(result)


if __name__ == "__main__":
    sys.exit(main())
