#!/usr/bin/env python
"""Run a whole reference sweep in one process on the PyTorch/CUDA port.

    python -m vae_training_tpu_torch._scripts.sweep linear --grouped  # 21 runs
    python -m vae_training_tpu_torch._scripts.sweep sigmoid --grouped # 18 runs
    python -m vae_training_tpu_torch._scripts.sweep sphere --grouped  # 15 runs

(console script ``vae-sweep-torch``). Port of
``vae_training_tpu/_scripts/sweep.py``: the same grids as the reference's
``*_expts.sh`` scripts and the same run names. ``--grouped`` trains the
whole sweep as one launch per chunk: K6a, the linear kernel's grid mode,
takes the linear and sigmoid sweeps, K6b, the MLP kernel's grid mode, the
sphere sweep; a row set neither takes (``--kernels torch``, or rows that
differ in more than dims and seeds) trains as one seed grid per row.
Without ``--grouped`` the runs go one after another in this process.
``--adam_dtype bf16`` trains every run with bfloat16 Adam moments (on the
same kernels). ``--shard K/N`` trains a disjoint round-robin share;
``--report`` summarises a finished sweep from its artifacts.

``--grouped --mesh dp=N`` shards each launch's rows over the N ranks of a
``torch.distributed`` run (one process a device, started by torchrun; the
process group comes up when ``WORLD_SIZE`` > 1): every rank trains its
block of the rows, with no collective, and writes only those rows'
directories (``train/mixed_grid.py``, ``train/grid.py``); ``--shard K/N``
composes with it, as in the JAX runner. Without ``--grouped`` the runs go
one after another and ``--mesh`` raises.

Not ported: ``--isolate`` / ``--row_timeout`` / ``--retries``, the TPU
init-hang supervision (ROADMAP Queue 1 item 12); each raises naming its
item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from vae_training_tpu_torch.config import RunConfig, use_fp32_math
from vae_training_tpu_torch.utils.process import init_distributed

# (data_dim, padding_dim, latent_dim) rows: the reference's sweeps
LINEAR_GRID = [(3, 9, 20), (3, 17, 20), (6, 6, 20), (6, 14, 20),
               (9, 3, 20), (9, 11, 10), (12, 8, 10)]
SIGMOID_GRID = [(3, 3, 6), (3, 13, 8), (5, 16, 16), (5, 5, 10),
                (7, 7, 13), (7, 20, 24)]
SPHERE_GRID = [(3, 3, 6), (3, 13, 8), (5, 16, 16), (5, 5, 10), (7, 7, 13)]
SWEEP_SEEDS = {"linear": [2, 3, 4], "sigmoid": [69, 24, 48], "sphere": [69, 24, 48]}


def sweep_configs(sweep: str, data_dir: str, num_batches, kernels: str,
                  adam_dtype: str = "f32", device: str = "cuda"):
    """The sweep's run configs, in the reference's order."""
    if sweep == "linear":
        for seed in (2, 3, 4):
            for dd, pd, ld in LINEAR_GRID:
                yield RunConfig(
                    name=f"vae{dd}linear_gaussian_{dd + pd}dim{seed}",
                    dataset="linear_gaussian", encoder_layer_sizes="",
                    layer_sizes="", overwrite=True, latent_dimension=ld,
                    padding_dim=pd, dataset_dimension=dd,
                    num_batches=num_batches or 100000, epsilon=-1.0,
                    tunable_decoder_var=True, dataset_seed=seed,
                    learning_rate=1e-3, data_dir=data_dir, kernels=kernels,
                    tqdm=False, adam_dtype=adam_dtype, device=device)
    elif sweep in ("sigmoid", "sphere"):
        hidden = "200|200|200" if sweep == "sphere" else ""
        for seed in (None, 24, 48):
            for dd, pd, ld in (SPHERE_GRID if sweep == "sphere" else SIGMOID_GRID):
                name = f"{sweep}_dd{dd}_pd{pd}_ld_{ld}_eps-3"
                if seed is not None:
                    name += f"_seed{seed}"
                yield RunConfig(
                    name=name, dataset=sweep, encoder_layer_sizes=hidden,
                    layer_sizes=hidden, overwrite=True, latent_dimension=ld,
                    padding_dim=pd, dataset_dimension=dd,
                    num_batches=num_batches or 150000, epsilon=-3.0,
                    tunable_decoder_var=True,
                    dataset_seed=seed if seed is not None else 69,
                    data_dir=data_dir, kernels=kernels, tqdm=False,
                    adam_dtype=adam_dtype, device=device)
    else:
        raise ValueError(f"unknown sweep {sweep!r}")


def cfg_to_argv(cfg: RunConfig):
    """A RunConfig as a ``vae-train-torch`` invocation."""
    argv = [
        cfg.name, "--dataset", cfg.dataset,
        "--encoder_layer_sizes", cfg.encoder_layer_sizes,
        "--layer_sizes", cfg.layer_sizes,
        "--latent_dim", str(cfg.latent_dimension),
        "--padding_dim", str(cfg.padding_dim),
        "-dd", str(cfg.dataset_dimension),
        "--num_batches", str(cfg.num_batches),
        "--batch_size", str(cfg.batch_size),
        "--epsilon", str(cfg.epsilon),
        "-ds", str(cfg.dataset_seed),
        "-lr", str(cfg.learning_rate),
        "--data_dir", cfg.data_dir,
        "--kernels", cfg.kernels,
        "--checkpoint_every", str(cfg.checkpoint_every),
        "--adam_dtype", cfg.adam_dtype,
        "--device", cfg.device,
    ]
    if cfg.tunable_decoder_var:
        argv.append("-tdv")
    if cfg.overwrite:
        argv.append("-ow")
    return argv


def parse_shard(spec: str):
    """'K/N' → (k, n): this process trains share k of n, round-robin."""
    if not spec:
        return 0, 1
    try:
        k_s, n_s = spec.split("/", 1)
        k, n = int(k_s), int(n_s)
    except ValueError:
        raise SystemExit(f"--shard expects 'K/N', got {spec!r}")
    if n < 1 or not 0 <= k < n:
        raise SystemExit(f"--shard {spec!r}: need 0 <= K < N")
    return k, n


def shard_items(items, shard):
    k, n = shard
    return [x for i, x in enumerate(items) if i % n == k]


def run_grouped(sweep: str, data_dir: str, num_batches, kernels: str,
                mesh: str = "", resume: bool = False, shard=(0, 1), device: str = "cuda",
                adam_dtype: str = "f32") -> int:
    """Every row's seeds as one grid; with ``--kernels auto|cuda`` first the
    whole sweep as one launch per chunk (``run_mixed_sweep``), and per-row
    grids where that is unavailable (``MixedSweepUnavailable``, raised
    before any IO). ``mesh`` (e.g. 'dp=3') shards each launch's rows over
    the run's ranks. ``shard`` partitions the row groups round-robin."""
    from vae_training_tpu_torch.train.grid import run_seed_grid

    seeds = SWEEP_SEEDS[sweep]
    rows = {}
    for cfg in sweep_configs(sweep, data_dir, num_batches, kernels, adam_dtype=adam_dtype,
                             device=device):
        key = (cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension)
        rows.setdefault(key, {})[cfg.dataset_seed] = cfg
    if shard != (0, 1):
        keep = shard_items(list(rows), shard)
        rows = {k: rows[k] for k in keep}
        print(f"[sweep] shard {shard[0]}/{shard[1]}: {len(rows)} row groups "
              f"{sorted(rows)}", flush=True)
        if not rows:
            print("[sweep] shard owns no rows; nothing to do", flush=True)
            return 0

    if kernels in ("auto", "cuda"):
        from vae_training_tpu_torch.train.mixed_grid import (
            MixedSweepUnavailable,
            run_mixed_sweep,
        )

        mixed_rows = [(by_seed[seeds[0]], seeds, {s: by_seed[s].name for s in seeds})
                      for by_seed in rows.values()]
        try:
            t0 = time.perf_counter()
            rc = run_mixed_sweep(mixed_rows, mesh_spec=mesh, resume=resume)
            print(f"[sweep] ONE-LAUNCH {sweep}: {len(rows)} rows × {len(seeds)} seeds"
                  + (f" sharded over {mesh}" if mesh else "")
                  + f" in {time.perf_counter() - t0:.1f}s", flush=True)
            return rc
        except MixedSweepUnavailable as e:
            print(f"[sweep] one-launch unavailable ({e}); per-row grid launches",
                  flush=True)

    for key, by_seed in rows.items():
        cfg = by_seed[seeds[0]]
        cfg.mesh = mesh
        if resume:
            cfg.resume = "rows"  # grid semantics: each row's own output dir
        t0 = time.perf_counter()
        run_seed_grid(cfg, seeds, name_fn=lambda s, by_seed=by_seed: by_seed[s].name)
        print(f"[sweep] row dd={key[0]} pd={key[1]} ld={key[2]} ({len(seeds)} seeds) "
              f"done in {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


# Each family's convergence channel; the threshold is the published plots'
# collapse criterion (padding energy → 0).
REPORT_CHANNELS = {
    "linear": "Squared Norm of padding dimensions",
    "sigmoid": "Squared Norm of Padding Dimensions",
    "sphere": "Padding Error",
}


def run_report(sweep: str, data_dir: str, threshold: float = 0.01) -> int:
    """Summarise a finished sweep from its artifacts, on the host: each
    run's final smoothed loss, padding channel and whether it converged,
    and the family total. Returns 1 if any run's artifacts are missing."""
    import numpy as np

    channel = REPORT_CHANNELS[sweep]
    rows, missing, converged = [], [], 0
    for cfg in sweep_configs(sweep, data_dir, None, "auto"):
        path = os.path.join(data_dir, cfg.name, "losses.npz")
        try:
            z = np.load(path, allow_pickle=True)
            loss = np.asarray(z["VAE Loss"], np.float64)
            pad = np.asarray(z[channel], np.float64).reshape(-1)
        except Exception as e:  # a missing or truncated npz: report, go on
            missing.append(f"{cfg.name} ({type(e).__name__})")
            continue
        final_loss = float(loss[-min(100, loss.size):].mean()) if loss.size else float("nan")
        final_pad = float(pad[-1]) if pad.size else float("nan")
        ok = final_pad < threshold
        converged += bool(ok)
        rows.append((cfg.name, final_loss, final_pad, ok))
    name_w = max((len(r[0]) for r in rows), default=4)
    print(f"{'run':<{name_w}}  {'final loss':>12}  {'padding':>12}  conv")
    for name, fl, fp, ok in rows:
        print(f"{name:<{name_w}}  {fl:>12.4f}  {fp:>12.6f}  {'yes' if ok else 'NO'}")
    print(f"[report] {sweep}: {converged}/{len(rows)} rows converged "
          f"({channel} < {threshold})" + (f"; MISSING: {missing}" if missing else ""),
          flush=True)
    return 1 if missing else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sweep", choices=["linear", "sigmoid", "sphere"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--num_batches", type=int, default=None,
                   help="Override the sweep's per-run step count.")
    p.add_argument("--kernels", default="auto", choices=["auto", "torch", "cuda"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to train on; cuda without a CUDA device is an error.")
    p.add_argument("--grouped", action="store_true",
                   help="Train each row's seeds as one grid, and the whole sweep as "
                        "one launch a chunk where K6a or K6b takes every row.")
    p.add_argument("--resume", action="store_true",
                   help="With --grouped: continue a stopped sweep from every row's "
                        "own checkpoint.")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="Between-chunk checkpoints of each run (without --grouped).")
    p.add_argument("--report", action="store_true",
                   help="Summarise a finished sweep from its artifacts.")
    p.add_argument("--shard", default="",
                   help="'K/N': train only this process's round-robin share (row "
                        "groups with --grouped, runs otherwise).")
    p.add_argument("--mesh", default="",
                   help="With --grouped: shard each launch's rows over the run's ranks, "
                        "e.g. 'dp=3' (torchrun, one process a device).")
    # the JAX runner's flags whose machinery is not ported: each raises
    p.add_argument("--isolate", action="store_true",
                   help="Not ported (ROADMAP Queue 1 item 12).")
    p.add_argument("--row_timeout", type=float, default=None,
                   help="Not ported (ROADMAP Queue 1 item 12).")
    p.add_argument("--retries", type=int, default=None,
                   help="Not ported (ROADMAP Queue 1 item 12).")
    p.add_argument("--adam_dtype", default="f32", choices=["f32", "bf16"],
                   help="Adam moment storage of every run (vae-train-torch's "
                        "--adam_dtype).")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.isolate or args.row_timeout is not None or args.retries is not None:
        raise NotImplementedError(
            "--isolate/--row_timeout/--retries supervise TPU init hangs and are left "
            "out of vae_training_tpu_torch; see ROADMAP Queue 1 item 12")
    if args.mesh and not args.grouped:
        raise ValueError("--mesh shards the rows of --grouped sweeps; add --grouped")
    shard = parse_shard(args.shard)
    if args.report:
        return run_report(args.sweep, args.data_dir)
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        init_distributed(False, args.device)  # WORLD_SIZE > 1: one rank of a sharded sweep
        return _run(args, shard)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, shard) -> int:
    use_fp32_math(args.device)
    t0 = time.perf_counter()
    if args.grouped:
        rc = run_grouped(args.sweep, args.data_dir, args.num_batches, args.kernels,
                         mesh=args.mesh, resume=args.resume, shard=shard,
                         device=args.device, adam_dtype=args.adam_dtype)
        print(f"[sweep] grouped {args.sweep} in {time.perf_counter() - t0:.1f}s",
              flush=True)
        return rc
    if args.resume:
        raise ValueError("--resume applies to --grouped sweeps")
    from vae_training_tpu_torch._scripts.run import main as run_one

    all_cfgs = list(sweep_configs(args.sweep, args.data_dir, args.num_batches,
                                  args.kernels, adam_dtype=args.adam_dtype,
                                  device=args.device))
    cfgs = shard_items(all_cfgs, shard)
    if shard != (0, 1):
        print(f"[sweep] shard {shard[0]}/{shard[1]}: {len(cfgs)} of {len(all_cfgs)} runs",
              flush=True)
    failed = []
    for cfg in cfgs:
        cfg.checkpoint_every = args.checkpoint_every
        t1 = time.perf_counter()
        ok = run_one(cfg) == 0
        if not ok:
            failed.append(cfg.name)
        print(f"[sweep] {cfg.name} {'done' if ok else 'FAILED'} in "
              f"{time.perf_counter() - t1:.1f}s", flush=True)
    print(f"[sweep] {len(cfgs)} runs in {time.perf_counter() - t0:.1f}s"
          + (f"; FAILED: {failed}" if failed else ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
