"""Parallel backends over ``torch.distributed`` ranks: the mesh, data
parallelism, tensor parallelism, and the gloo dry run of all of them
(``parallel/dryrun.py``). Port of ``vae_training_tpu/parallel/``."""

from .api import ParallelFns, make_parallel_step_fns
from .dp import DataParallel, data_parallel
from .gspmd import TensorParallel, param_sharding_tree, tensor_parallel
from .mesh import Mesh, make_mesh, parse_mesh_spec

__all__ = [
    "DataParallel", "Mesh", "ParallelFns", "TensorParallel", "data_parallel",
    "make_mesh", "make_parallel_step_fns", "param_sharding_tree", "parse_mesh_spec",
    "tensor_parallel",
]
