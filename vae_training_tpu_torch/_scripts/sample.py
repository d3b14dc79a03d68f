#!/usr/bin/env python
"""Generate samples from a trained run directory (the serving path).

    python -m vae_training_tpu_torch._scripts.sample data/<run_name> -n 1000 \
        -o samples.npz [--png tile.png] [--seed 0] [--device cuda|cpu]

(console script ``vae-sample-torch``). Port of
``vae_training_tpu/_scripts/sample.py``: rebuild the model from the run's
``args.json``, restore its parameters from the checkpoint (``ckpt.pt``;
else the reference-layout ``model.pkl``, which a JAX run's directory also
holds: its ``ckpt.msgpack`` is not read here), draw prior latents from the
Philox streams keyed ``--seed`` on the device, decode them once with the
learned decoder log-variance, and write an .npz of the samples and the
latents (z1 ⊕ z2), the dataset's scores, and with ``--png`` the dataset's
figure (skipped, with a note, where matplotlib is not installed).

``--device cuda`` (the default) needs a card; pass ``--device cpu`` to
sample on the CPU. Nothing falls back.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from vae_training_tpu_torch.config import RunConfig, use_fp32_math
from vae_training_tpu_torch.data import get_dataset
from vae_training_tpu_torch.runio import checkpoint_exists, load_model_pkl, restore_checkpoint
from vae_training_tpu_torch.train.loop import Trainer, check_params


def load_run(run_dir: str, device: str = "cuda") -> Trainer:
    """A Trainer holding the run's model and parameters on ``device``."""
    with open(os.path.join(run_dir, "args.json")) as f:
        manifest = json.load(f)
    known = {k: v for k, v in manifest.items() if k in RunConfig.__dataclass_fields__}
    cfg = RunConfig(**known)
    cfg.resume = None
    cfg.state_dict = None
    cfg.mesh = ""  # sampling is single-device
    cfg.kernels = "torch"  # a JAX run's args.json says "xla" or "pallas"
    cfg.device = device
    cfg.validate()
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg, device=torch.device(device))
    trainer = Trainer(cfg, dataset, run_dir)
    if checkpoint_exists(run_dir):
        state = restore_checkpoint(run_dir, device=trainer.device)
    else:
        state = load_model_pkl(os.path.join(run_dir, "model.pkl")).to(trainer.device)
    check_params(trainer.model, state, run_dir)
    trainer.state = state
    # thread the learned decoder log-variance into generation
    eps = state.params.get("epsilon")
    if eps is not None and cfg.tunable_decoder_var:
        trainer.current_epsilon = eps.detach().cpu().numpy() * cfg.epsilon
    return trainer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir", help="A run output directory (contains args.json)")
    p.add_argument("-n", "--num_samples", type=int, default=1000)
    p.add_argument("-o", "--out", default=None,
                   help="Output .npz (default: <run_dir>/samples.npz)")
    p.add_argument("--png", default=None, help="Also write a diagnostic plot to this path.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to sample on. cuda without a CUDA device is an error.")
    args = p.parse_args(argv)

    use_fp32_math(args.device)
    trainer = load_run(args.run_dir, args.device)
    samples, latents = trainer.sample_batch(args.seed, args.num_samples)
    samples_np, latents_np = samples.cpu().numpy(), latents.cpu().numpy()
    out = args.out or os.path.join(args.run_dir, "samples.npz")
    np.savez(out, samples=samples_np, latents=latents_np)
    print(f"wrote {args.num_samples} samples to {out}")
    score = trainer.dataset.score(samples)
    if score:
        print("scores:", {k: float(np.asarray(torch.as_tensor(v).cpu()).mean())
                          for k, v in score.items()})
    if args.png:
        if trainer.dataset.plot_batch(samples, fn=args.png):
            print(f"wrote plot to {args.png}")
        else:
            print("[plot] matplotlib is not installed; the plot is skipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
