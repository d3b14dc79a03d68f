"""Data parallelism over ranks: a shard of the batch each, the gradients
and the loss all-reduced as means.

Port of ``vae_training_tpu/parallel/dp.py``. Each rank of the mesh's data
axes trains ``batch_size // (dp_dcn·dp)`` rows of every step; the only
traffic is one all-reduce of the flattened gradients and loss a step,
over ``dp`` first and then over ``dp_dcn`` when it is present, the JAX
package's hierarchical order (``dp.py:87-93``), so that only a tensor
already reduced inside a host crosses hosts. Parameters and Adam state
stay replicated: every rank applies the same update.

Noise. The port's streams are counter-keyed Philox (``ops/rng.py``:
counter = step, row, draw, stream), so a rank draws rows
``[r·lb, (r+1)·lb)`` of the one-device draw (``row0``, with ``r`` the
rank's linearised (dp_dcn, dp) index and ``lb`` the local batch) instead
of folding its index into the key as the JAX package does. That keeps the
JAX package's stated invariant, ``dp_dcn=S,dp=N`` draws exactly what
``dp=S·N`` draws, and makes ``dp=N`` the single-device run up to the order
of the gradient sum.

On the card the step runs as the torch path's CUDA graph
(``train/step.py`` ``GraphChunk``) with its NCCL all-reduces captured in
it; on the CPU, under ``-nojit`` and under ``--debug_nans`` op by op over
gloo. Evals, generation and scoring run on the replicated parameters, as
in the JAX package (``dp.py:108-111``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh


@dataclass
class DataParallel:
    """A rank's share of the data axes: ``local_batch`` rows from ``row0``
    of every step's global batch, and the groups its gradients are
    averaged over, in order (``(group, size)``; a group of None is a
    one-rank axis with no process group)."""

    local_batch: int
    row0: int
    groups: List[Tuple[Optional[object], int]] = field(default_factory=list)

    def reduce(self, grads: Sequence[torch.Tensor], loss: torch.Tensor):
        """(gradients, loss) → their means over the data axes: one flat
        buffer, all-reduced (sum) and divided by each axis's size in turn."""
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        for group, size in self.groups:
            if group is not None:
                dist.all_reduce(flat, group=group)
            if size > 1:
                flat.div_(size)
        parts = torch.split(flat, [g.numel() for g in grads] + [1])
        return [p.view(g.shape) for p, g in zip(parts, grads)], parts[-1].view(())

    def loss(self, model, params, x, z1, z2) -> torch.Tensor:
        """The local ELBO loss (tensor parallelism overrides it)."""
        from ..train.step import loss_terms

        return loss_terms(model, params, x, z1, z2)[0]


def data_parallel(mesh: Mesh, batch_size: int, rank: int, device,
                  message: Optional[str] = None) -> DataParallel:
    """The ``DataParallel`` of ``rank`` (in the mesh) for a global batch of
    ``batch_size``; makes the mesh's device groups (a collective call).
    ``message`` overrides the JAX dp path's divisibility error."""
    dp = mesh.shape["dp"]
    dcn = mesh.shape.get("dp_dcn", 1)
    ndev = dp * dcn
    if batch_size % ndev != 0:
        raise ValueError(message or (
            f"--batch_size {batch_size} must be divisible by "
            f"dp_dcn*dp={ndev}" if dcn > 1 else
            f"--batch_size {batch_size} must be divisible by dp={ndev}"))
    groups = mesh.groups(device)
    local_bs = batch_size // ndev
    order = [("dp", dp)] + ([("dp_dcn", dcn)] if "dp_dcn" in mesh.shape else [])
    return DataParallel(local_batch=local_bs, row0=mesh.data_index(rank) * local_bs,
                        groups=[(groups.get(a), n) for a, n in order])
