#!/usr/bin/env python
"""Interrogate the sphere sweep's plateau rows on the PyTorch/CUDA port.

Counterpart of ``tools/interrogate_sphere.py``. The reference's full-length
sphere sweep leaves dd5_pd16 (all three dataset seeds) and dd7_pd7 seed48
on a plateau of the padding error. This campaign asks whether that is the
paper's landscape (a plateau for every init, dot precision and horizon) or
an artifact of the framework (some variant collapses):

  - baseline: model seed 0, ``--precision bf16``, 150k steps (the sweep's
    configuration);
  - (a) model seeds 1, 2 and 3: other init basins;
  - (b) ``--precision fp32``: true fp32 products in place of bf16 operands;
  - (c) 300k steps: twice the horizon.

Four rows times six variants: 24 solo runs, each through the CLI's
``main`` in this process (K5, the MLP kernel, on the card). Finished runs
(a complete losses.npz) are skipped, so an interrupted campaign continues
where it stopped when invoked again; a run that fails is logged and the
campaign goes on. Prints each run's final padding error, sphere error and
smoothed loss, then the markdown table of all of them:

    python -m vae_training_tpu_torch.tools.interrogate_sphere [--data_dir data/probe_sphere]

``--device cpu`` runs the plain versions on the CPU (tiny campaigns only:
a run is 150k steps of 200|200|200 stacks).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# the four plateau rows: (data_dim, padding_dim, latent_dim, dataset_seed)
ROWS = [(5, 16, 16, 69), (5, 16, 16, 24), (5, 16, 16, 48), (7, 7, 13, 48)]

# (tag, model_seed, precision, num_batches)
VARIANTS = [
    ("ms0", 0, "bf16", 150_000),
    ("ms1", 1, "bf16", 150_000),
    ("ms2", 2, "bf16", 150_000),
    ("ms3", 3, "bf16", 150_000),
    ("fp32", 0, "fp32", 150_000),
    ("300k", 0, "bf16", 300_000),
]


def make_cfg(dd, pd, ld, ds_seed, tag, model_seed, precision, num_batches, data_dir,
             device="cuda"):
    from vae_training_tpu_torch.config import RunConfig

    return RunConfig(
        name=f"probe_dd{dd}_pd{pd}_ld{ld}_s{ds_seed}_{tag}",
        dataset="sphere", encoder_layer_sizes="200|200|200",
        layer_sizes="200|200|200", latent_dimension=ld, padding_dim=pd,
        dataset_dimension=dd, num_batches=num_batches, epsilon=-3.0,
        tunable_decoder_var=True, dataset_seed=ds_seed,
        model_seed=model_seed, precision=precision, overwrite=True,
        tqdm=False, data_dir=data_dir, device=device,
    ).validate()


def run_done(out, num_batches):
    fn = os.path.join(out, "losses.npz")
    if not os.path.exists(fn):
        return False
    try:
        z = np.load(fn, allow_pickle=True)
        return z["VAE Loss"].shape[0] >= num_batches
    except Exception:  # a truncated npz: the run reruns
        return False


def final_metrics(out):
    z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
    losses = np.asarray(z["VAE Loss"], np.float64)
    pad = float(np.asarray(z["Padding Error"])[-1])
    sph = float(np.asarray(z["Sphere Error"])[-1])
    smoothed = float(losses[-2000:].mean())
    return pad, sph, smoothed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default="data/probe_sphere")
    p.add_argument("--kernels", default="auto", choices=["auto", "torch", "cuda"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to train on; cuda without a CUDA device is an error.")
    args = p.parse_args(argv)
    os.makedirs(args.data_dir, exist_ok=True)

    from vae_training_tpu_torch._scripts.run import main as run_main

    t0 = time.perf_counter()
    results = []
    for dd, pd, ld, ds_seed in ROWS:
        for tag, ms, prec, nb in VARIANTS:
            cfg = make_cfg(dd, pd, ld, ds_seed, tag, ms, prec, nb, args.data_dir,
                           device=args.device)
            cfg.kernels = args.kernels
            out = os.path.join(args.data_dir, cfg.name)
            if not run_done(out, nb):
                print(f"[probe] running {cfg.name}", flush=True)
                t1 = time.perf_counter()
                try:
                    run_main(cfg)  # returns 0 or raises
                except Exception as e:
                    # log and go on: one failed run must not end the campaign;
                    # it reruns when the campaign is invoked again
                    print(f"[probe] {cfg.name} FAILED ({type(e).__name__}: {e})", flush=True)
                    continue
                print(f"[probe] {cfg.name} took {time.perf_counter() - t1:.1f}s", flush=True)
            pad, sph, smoothed = final_metrics(out)
            row = (f"dd{dd}_pd{pd}_s{ds_seed}", tag, pad, sph, smoothed)
            results.append(row)
            print(f"[probe] {row[0]} {tag}: padding={pad:.4f} "
                  f"sphere={sph:.5f} loss={smoothed:+.3f}", flush=True)
    print(f"[probe] {len(results)} runs in {time.perf_counter() - t0:.1f}s", flush=True)

    print("\n| row | variant | final padding | sphere err | smoothed loss |")
    print("|---|---|---|---|---|")
    for name, tag, pad, sph, smoothed in results:
        print(f"| {name} | {tag} | {pad:.4f} | {sph:.5f} | {smoothed:+.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
