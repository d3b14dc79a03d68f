"""Parallel backend selection.

Port of ``vae_training_tpu/parallel/api.py``: ``dp=N`` (with ``dp_dcn``)
alone takes data parallelism (``parallel/dp.py``), a spec with ``tp`` > 1
takes tensor parallelism over the dp × tp mesh (``parallel/gspmd.py``).
The process bring-up is the caller's (``utils/process.init_distributed``).

``make_parallel_step_fns`` returns what the engine needs beside the
model: the chunk (``train_chunk(state, n_steps)``, or for an epoch
dataset ``EpochChunk``'s ``chunk(state, epoch, n_batches)``), ``place_state``
and ``full_state`` (identity for dp; the shard and the all-gather for tp),
and the ``[kernels]`` line's form. A rank past an uneven mesh's size
makes the device groups with the others and gets ``active=False``: it
trains nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

from .dp import data_parallel
from .gspmd import tensor_parallel
from .mesh import Mesh, make_mesh


def _same(state):
    return state


@dataclass
class ParallelFns:
    train_chunk: Optional[Callable]
    place_state: Callable = _same
    full_state: Callable = _same
    mesh: Optional[Mesh] = None
    kind: str = ""  # "data parallel over dp=2", for the [kernels] line
    form: str = ""  # how a step runs, for the [kernels] line
    active: bool = True


def make_parallel_step_fns(model, dataset, cfg, *, graph: bool, form: str,
                           debug_wrap: Callable = _same) -> ParallelFns:
    """The chunk over ``cfg.mesh`` for this rank. ``graph`` says whether the
    dp step runs as the torch path's CUDA graph (``kernels/dispatch.py``
    ``torch_path_form``: on the card, not under ``-nojit`` or
    ``--debug_nans``), ``form`` is that form's words, and ``debug_wrap``
    wraps an op-by-op chunk (``--debug_nans``' anomaly mode)."""
    import torch

    from ..train import step as torch_step
    from ..utils.process import process_index

    mesh = make_mesh(cfg.mesh, allow_uneven=cfg.mesh_allow_uneven)
    device = torch.device(cfg.device)
    rank = process_index()
    shape = ",".join(f"{k}={v}" for k, v in mesh.shape.items())
    if not mesh.contains(rank):
        mesh.groups(device)  # every process makes every group
        return ParallelFns(None, mesh=mesh, active=False,
                           kind=f"rank {rank} is outside the mesh {shape}",
                           form="it trains nothing")
    kw = dict(batch_size=cfg.batch_size, lr=float(cfg.learning_rate))
    tp = mesh.shape.get("tp", 1)
    if tp > 1:
        par = tensor_parallel(mesh, model, cfg.batch_size, rank, device,
                              allow_replicated=cfg.tp_allow_replicated)
        chunk = debug_wrap(partial(torch_step.train_chunk, model, dataset, dp=par, **kw))
        return ParallelFns(chunk, place_state=par.place_state, full_state=par.full_state,
                           mesh=mesh, kind=f"tensor parallel over {shape}",
                           form=("op by op (tp's collectives run inside the forward and "
                                 "the backward)"))
    par = data_parallel(mesh, cfg.batch_size, rank, device)
    if dataset.is_epochs:
        chunk = torch_step.EpochChunk(model, dataset, graph=graph, dp=par, **kw)
        form = "one CUDA graph replay an epoch" if graph else f"{form}, one epoch a chunk"
        chunk = debug_wrap(chunk)
    elif graph:
        chunk = torch_step.GraphChunk(model, dataset, dp=par, **kw)
    else:
        chunk = debug_wrap(partial(torch_step.train_chunk, model, dataset, dp=par, **kw))
    captured = ", the all-reduces captured in it" if graph else ""
    return ParallelFns(chunk, mesh=mesh, kind=f"data parallel over {shape}",
                       form=form + captured)
