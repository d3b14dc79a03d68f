"""Device mesh resolution from a CLI spec string, over the ranks of a run.

Port of ``vae_training_tpu/parallel/mesh.py``. A JAX mesh device is a rank
of the default process group here (one process a device, its device
``cuda:LOCAL_RANK`` or the CPU), so the "device list" is the world size.

Spec grammar (unchanged): comma-separated ``axis=size``, e.g. ``"dp=8"``,
``"dp=4,tp=2"`` or ``"dp_dcn=2,dp=4"``, over the axes

- ``dp``: data parallel, the batch sharded and the gradients all-reduced;
- ``tp``: tensor parallel, the MLP's Dense kernels sharded
  (``parallel/gspmd.py``);
- ``dp_dcn``: a second data-parallel level across hosts, always the
  outermost axis, so that a reduction over it crosses hosts once, after
  the reduction over ``dp`` inside each host (``parallel/dp.py``).

``axis=-1`` means "all remaining devices". The mesh always carries a
``dp`` axis. Ranks map to coordinates in row-major order over the
canonical axes (``dp_dcn``, ``dp``, ``tp``), as the JAX package's
``np.array(devices).reshape(...)`` does: ``dp_dcn`` leads, ``tp`` groups
are adjacent ranks. A rank past the mesh's size (a ``-1`` wildcard
resolved with ``--mesh_allow_uneven``) trains nothing, as an idle chip.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

SUPPORTED_AXES = ("dp_dcn", "dp", "tp")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    axes: Dict[str, int] = {}
    if not spec:
        return axes
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"Bad mesh spec segment {part!r}; expected axis=size")
        name, size = part.split("=", 1)
        name = name.strip()
        if name not in SUPPORTED_AXES:
            raise ValueError(
                f"Unsupported mesh axis {name!r}; supported: {SUPPORTED_AXES}"
            )
        if name in axes:
            raise ValueError(f"Duplicate mesh axis {name!r} in {spec!r}")
        size = int(size)
        if size == 0 or size < -1:
            raise ValueError(
                f"Bad size for mesh axis {name}={size}; expected a positive "
                f"integer or -1 (all remaining devices)"
            )
        axes[name] = size
    return axes


@dataclass
class Mesh:
    """A resolved mesh: ``shape`` ({axis: size} in canonical order) and
    ``ranks``, the ranks laid out in that shape. ``groups(device)`` makes
    the per-axis process groups for device collectives."""

    shape: Dict[str, int]
    ranks: np.ndarray
    _groups: dict = field(default_factory=dict, repr=False)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def contains(self, rank: int) -> bool:
        return rank < self.size

    def coords(self, rank: int) -> Optional[Dict[str, int]]:
        """{axis: index} of ``rank``, None for a rank the mesh leaves out."""
        if not self.contains(rank):
            return None
        idx = np.unravel_index(rank, self.ranks.shape)
        return {n: int(i) for n, i in zip(self.shape, idx)}

    def data_index(self, rank: int) -> int:
        """The rank's linearised (dp_dcn, dp) index: its batch shard. It
        equals the flat ``dp`` index of the same rank under
        ``dp=dp_dcn·dp``, so the two meshes draw the same shards."""
        c = self.coords(rank)
        return c.get("dp_dcn", 0) * self.shape["dp"] + c["dp"]

    def groups(self, device) -> Dict[str, object]:
        """{axis: this rank's process group along it} for collectives on
        ``device``'s tensors (``utils/process.device_group``: NCCL on the
        card, gloo on the CPU); none for a rank the mesh leaves out. Every
        process of the run must call it at the same point: each axis's
        groups are made in a fixed order, members or not. Made once a
        device type; ``{}`` without a process group (one rank)."""
        import torch
        import torch.distributed as dist

        from ..utils.process import device_group, process_index

        kind = torch.device(device).type
        if kind in self._groups:
            return self._groups[kind]
        mine: Dict[str, object] = {}
        if dist.is_initialized():
            rank = process_index()
            for k, axis in enumerate(self.shape):
                moved = np.moveaxis(self.ranks, k, -1).reshape(-1, self.shape[axis])
                for members in moved:
                    g = device_group(members.tolist(), device)
                    if rank in members:
                        mine[axis] = g
        self._groups[kind] = mine
        return mine



def make_mesh(spec: str, devices=None, allow_uneven: bool = False) -> Mesh:
    """Build the Mesh. The result always carries a ``dp`` axis (inserted as
    dp=1 for tp-only specs). ``devices`` is the number of devices (ranks),
    or a sequence of them; the default is the world size.

    A ``-1`` wildcard that cannot use every device is an error unless
    ``allow_uneven=True`` (CLI: ``--mesh_allow_uneven``): silently
    training on k<N devices is a throughput loss a user must acknowledge
    explicitly. A mesh larger than the world raises; it never runs on
    fewer devices."""
    from ..utils.process import process_count

    axes = parse_mesh_spec(spec)
    if not axes:
        raise ValueError("Empty mesh spec")
    if "dp" not in axes:
        axes["dp"] = 1
    axes = {n: axes[n] for n in SUPPORTED_AXES if n in axes}
    if devices is None:
        devices = process_count()
    n_devices = devices if isinstance(devices, int) else len(devices)
    wildcards = [n for n, s in axes.items() if s == -1]
    if len(wildcards) > 1:
        raise ValueError(
            f"At most one mesh axis may be -1, got {wildcards} in {spec!r}"
        )
    known = int(np.prod([s for s in axes.values() if s > 0]))
    for name in wildcards:
        resolved = n_devices // known
        if resolved < 1:
            raise ValueError(
                f"Mesh axis {name}=-1 resolves to 0: the explicit axes "
                f"{ {n: s for n, s in axes.items() if s > 0} } already need "
                f"{known} devices but only {n_devices} are available"
            )
        if known * resolved != n_devices:
            if not allow_uneven:
                raise ValueError(
                    f"Mesh axis {name}=-1 would use only "
                    f"{known * resolved}/{n_devices} devices "
                    f"({n_devices} not divisible by {known}); idle chips "
                    f"are a silent throughput loss. Pass an explicit size "
                    f"or --mesh_allow_uneven to accept it."
                )
            print(
                f"[mesh] {name}=-1 -> {resolved}: using "
                f"{known * resolved}/{n_devices} devices "
                f"({n_devices} not divisible by {known})",
                file=sys.stderr, flush=True,
            )
        axes[name] = resolved
    total = int(np.prod(list(axes.values())))
    if total > n_devices:
        raise ValueError(
            f"Mesh {axes} needs {total} devices but only {n_devices} available"
        )
    return Mesh(dict(axes), np.arange(total).reshape(tuple(axes.values())))
