#!/usr/bin/env python
"""CLI entry point: the reference's flag surface on the PyTorch/CUDA port.

    python -m vae_training_tpu_torch._scripts.run <name> --dataset linear_gaussian ...

(console script ``vae-train-torch``). Port of
``vae_training_tpu/_scripts/run.py:32-103``: validate the config, make the
output dir and args.json, build the dataset and the trainer, train, final
save. ``--device`` names the device; ``--kernels`` the backend.
"""

from __future__ import annotations

import os
import sys

import torch

from vae_training_tpu_torch.config import RunConfig, parse_arguments
from vae_training_tpu_torch.data import get_dataset
from vae_training_tpu_torch.runio import make_output_dir
from vae_training_tpu_torch.train.loop import Trainer


def main(cfg: RunConfig) -> int:
    cfg.validate()
    device = torch.device(cfg.device)
    if device.type == "cuda":
        # --precision: both values are true fp32 in this port
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name = torch.cuda.get_device_name(device)
    else:
        name = "cpu"
    print(f"device: {cfg.device} ({name})", file=sys.stderr, flush=True)
    # Resuming in place reuses the run's own directory; resuming from
    # another run into a fresh name keeps the refuse-to-clobber guarantee.
    own_dir = os.path.join(cfg.data_dir or "data", cfg.name)
    resume_in_place = bool(cfg.resume) and (
        os.path.realpath(cfg.resume) == os.path.realpath(own_dir))
    if (cfg.resume and not resume_in_place and cfg.overwrite
            and (os.path.realpath(cfg.resume) + os.sep).startswith(
                os.path.realpath(own_dir) + os.sep)):
        raise ValueError(
            f"--resume {cfg.resume} lies inside the output dir {own_dir} "
            f"that -ow would wipe; resume in place (--resume {own_dir}) "
            f"or pick a different run name")
    output_dir = make_output_dir(cfg.name, cfg.overwrite, cfg,
                                 data_dir=cfg.data_dir,
                                 reuse_existing=resume_in_place)
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg, device=device)
    if cfg.data_fn:
        loaded = dataset.load(cfg.data_fn)
        dataset = loaded if loaded is not None else dataset
    trainer = Trainer(cfg, dataset, output_dir)
    trainer.train_distribution()
    trainer.save(final=True)
    return 0


def cli(argv=None) -> int:
    """Console entry point (``vae-train-torch``)."""
    return main(parse_arguments(argv))


if __name__ == "__main__":
    sys.exit(cli())
