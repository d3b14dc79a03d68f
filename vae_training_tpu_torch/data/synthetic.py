"""Synthetic manifold datasets. This slice ports ``linear_gaussian``.

Port of ``vae_training_tpu/data/synthetic.py:157-229``. Y = A·X with
X ~ N(0, I_k) and A full-rank (dim × k), zero-padded to the ambient
dimension, plus optional isotropic observation noise of variance
``var_added``.

``A`` is drawn with numpy from the dataset seed, resampled until it has
full rank (the reference's construction loop). The JAX package draws it
with threefry, which this port does not reproduce, so ``create`` also
accepts an injected ``A``: the parity tests pass in the JAX dataset's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import rng
from .base import DistributionDataset, pad_with_zeros, padding_energy


class LinearGaussianDataset(DistributionDataset):
    """Y = A X with X ~ N(0, I_k), A full-rank (dim × k), zero padding."""

    def __init__(self, A: torch.Tensor, dim: int, intrinsic_dim: int,
                 padding_dim: int = 0, var_added: float = 0.0):
        if tuple(A.shape) != (dim, intrinsic_dim):
            raise ValueError(f"A must be ({dim}, {intrinsic_dim}), got {tuple(A.shape)}")
        self.A = A.to(torch.float32)
        self.dim = dim
        self.intrinsic_dim = intrinsic_dim
        self.padding_dim = padding_dim
        self.var_added = float(var_added)

    @classmethod
    def create(cls, seed: int, dimension: int = 3, intrinsic_dimension: int = 3,
               padding_dimension: int = 0, var_added: float = 0.0,
               A: Optional[np.ndarray] = None,
               device="cpu") -> "LinearGaussianDataset":
        if A is None:
            target_rank = min(dimension, intrinsic_dimension)
            gen = np.random.default_rng(seed)
            while True:
                A = gen.standard_normal((dimension, intrinsic_dimension))
                if int(np.linalg.matrix_rank(A)) == target_rank:
                    break
        A = torch.tensor(np.asarray(A, np.float32), device=device)
        return cls(A, dimension, intrinsic_dimension, padding_dimension, var_added)

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim

    def sample(self, seed: int, step: int, n: int) -> torch.Tensor:
        """(n, ndim) batch at counter ``step`` of the stream keyed ``seed``:
        intrinsic normals from STREAM_MANIFOLD, observation noise from
        STREAM_OBS."""
        lat = rng.normals(seed, step, n, rng.STREAM_MANIFOLD,
                          self.intrinsic_dim, device=self.device)
        y = pad_with_zeros(lat @ self.A.T, self.padding_dim)
        if self.var_added > 0:
            noise = rng.normals(seed, step, n, rng.STREAM_OBS, self.ndim,
                                device=self.device)
            y = y + noise * float(np.sqrt(np.float32(self.var_added)))
        return y

    def score(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"Squared Norm of padding dimensions":
                padding_energy(batch[:, self.dim:])}

    def plot_batch(self, batch, fn=None) -> bool:
        """Sorted-norm curve (2-D scatter for dim 2); skipped, returning
        False, where matplotlib is not installed."""
        try:
            import matplotlib
        except ImportError:
            return False
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        b = np.asarray(batch.detach().cpu())
        if self.dim == 2:
            plt.scatter(b[:, 0], b[:, 1])
        else:
            plt.plot(np.sort(np.linalg.norm(b, axis=1)))
            plt.ylabel("Norm of points")
        plt.title(f"Gaussian with dimension {self.dim} and padding {self.padding_dim}")
        if fn is not None:
            plt.savefig(fn)
        plt.close()
        return True
