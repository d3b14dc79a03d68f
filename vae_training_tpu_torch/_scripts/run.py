#!/usr/bin/env python
"""CLI entry point: the reference's flag surface on the PyTorch/CUDA port.

    python -m vae_training_tpu_torch._scripts.run <name> --dataset linear_gaussian ...

(console script ``vae-train-torch``). Port of
``vae_training_tpu/_scripts/run.py:32-103``: validate the config, start
the process group (``--multihost`` or ``WORLD_SIZE`` > 1), make the
output dir and args.json, build the dataset and the trainer, train, final
save; ``--seed_grid`` routes to ``train/grid.py:run_seed_grid``.
``--device`` names the device; ``--kernels`` the backend; ``--mesh`` the
ranks' mesh. ``--debug_nans`` (the JAX CLI's ``jax_debug_nans``) is read
by the engine (``train/loop.py``). On several GPUs, one process each:

    torchrun --nproc_per_node N -m vae_training_tpu_torch._scripts.run <name> ... --mesh dp=N
"""

from __future__ import annotations

import os
import sys

import torch

from vae_training_tpu_torch.config import RunConfig, parse_arguments, use_fp32_math
from vae_training_tpu_torch.data import get_dataset
from vae_training_tpu_torch.runio import make_output_dir
from vae_training_tpu_torch.train.loop import Trainer
from vae_training_tpu_torch.utils.process import (init_distributed, process_count,
                                                  process_index)


def main(cfg: RunConfig) -> int:
    # validate before the handshake: a config error fails fast on every
    # process rather than inside an init that waits for its peers
    cfg.validate()
    init_distributed(cfg.multihost, cfg.device)
    device = torch.device(cfg.device)
    use_fp32_math(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    where = (f", rank {process_index()} of {process_count()}"
             if process_count() > 1 else "")
    print(f"device: {cfg.device} ({name}){where}", file=sys.stderr, flush=True)
    if cfg.seed_grid:
        from vae_training_tpu_torch.train.grid import run_seed_grid

        return run_seed_grid(cfg, cfg.grid_seeds())
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
    trainer.train()
    trainer.save(final=True)
    return 0


def cli(argv=None) -> int:
    """Console entry point (``vae-train-torch``); ends the process group
    that ``main`` started."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        return main(parse_arguments(argv))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(cli())
