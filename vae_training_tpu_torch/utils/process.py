"""Multi-process roles, the process bring-up and the host handshakes.

Port of ``vae_training_tpu/utils/process.py``. A torch run is one process
a device: the JAX package's process index is the rank of the default
process group (``torch.distributed``), and process 0 writes every
artifact (``is_primary``). With no process group the run is one process,
rank 0 of 1.

The bring-up (``init_distributed``, called by the CLI and the sweep
runner after the config is validated) starts the default group over
**gloo** when ``--multihost`` is set or ``WORLD_SIZE`` > 1. It reads
torchrun's environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``, or an ``init_method`` URL in
``VAE_INIT_METHOD`` (``file://...`` or ``tcp://host:port``). On the card
the process takes ``cuda:LOCAL_RANK``. The default group carries only host
objects: barriers, ``check_shared_fs``'s all-gather. Collectives on device
tensors go over groups made by ``device_group`` (NCCL on the card, gloo on
the CPU; the device decides, never a fallback), and only the paths that
reduce gradients or activations make them, so processes that share one
card (a sharded seed grid trains with no collective) never open NCCL.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

INIT_METHOD_ENV = "VAE_INIT_METHOD"


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True iff this is the artifact-writing process (rank 0; trivially
    True in single-process runs)."""
    return process_index() == 0


def init_distributed(multihost: bool, device: str = "cuda") -> None:
    """Start the default process group (gloo) when ``multihost`` or
    ``WORLD_SIZE`` > 1, and take ``cuda:LOCAL_RANK`` on the card. A group
    the caller started already is kept."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or not (multihost or world > 1):
        return
    init_method = os.environ.get(INIT_METHOD_ENV) or "env://"
    need = ["RANK", "WORLD_SIZE"] + (["MASTER_ADDR", "MASTER_PORT"]
                                     if init_method == "env://" else [])
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost needs {', '.join(missing)} in the environment (torchrun "
            f"sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; "
            f"{INIT_METHOD_ENV} may name a file:// or tcp:// init_method instead "
            f"of MASTER_ADDR/MASTER_PORT)")
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo", init_method=init_method,
                            rank=int(os.environ["RANK"]), world_size=world)


def device_group(ranks, device) -> "dist.ProcessGroup":
    """A new group over ``ranks`` for collectives on ``device``'s tensors:
    NCCL on a CUDA device, gloo on the CPU. Every process of the default
    group must call it, in the same order, whether or not it is a member."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    return dist.new_group(list(ranks), backend=backend)


def barrier() -> None:
    """Every process waits here for every other (no-op single-process)."""
    if process_count() > 1:
        dist.barrier()


def check_shared_fs(exists, path: str, what: str = "checkpoint") -> None:
    """Make the multi-process restore path's shared-filesystem assumption
    explicit. Every process restores a checkpoint itself, which silently
    requires ``path`` on a filesystem all of them see: gather each
    process's view and fail, with the requirement spelled out, when they
    disagree. No-op single-process.

    ``exists`` is one bool (solo runs: the checkpoint dir) or a sequence of
    bools (grid runs: one per row dir). The per-row form matters: with
    per-host disks each process sees exactly its own rows' checkpoints, so
    a single ``all(...)`` aggregate would be False on every process, the
    guard would pass and the restore would die later on a raw
    FileNotFoundError for the first row it does not see."""
    if process_count() == 1:
        return
    local = np.atleast_1d(np.asarray(exists, np.int32))
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, local)
    flags = np.stack(gathered).reshape(process_count(), -1)  # (process, entry)
    disagree = [int(j) for j in np.nonzero((flags != flags[0:1]).any(axis=0))[0]]
    if disagree:
        def procs(mask):
            return [int(p) for p in np.nonzero(mask)[0]]

        detail = "; ".join(
            (f"entry {j}: " if flags.shape[1] > 1 else "")
            + f"visible to process(es) {procs(flags[:, j])} but NOT to "
              f"{procs(1 - flags[:, j])}"
            for j in disagree[:8])
        raise ValueError(
            f"multihost restore: the {what} at {path!r} is not uniformly "
            f"visible across processes ({detail}). Multi-process "
            f"--resume/--state_dict requires the run directory on a SHARED "
            f"filesystem mounted on every host — each process restores the "
            f"checkpoint itself; divergent visibility would crash the "
            f"missing process or silently fork the run."
        )
