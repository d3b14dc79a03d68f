"""Synthetic manifold datasets: ``gaussian``, ``linear_gaussian``, ``sigmoid``
and ``sphere``.

Port of ``vae_training_tpu/data/synthetic.py:65-290``. Each dataset samples
with the counter-keyed Philox streams of ``ops/rng.py``: the manifold
normals come from ``STREAM_MANIFOLD`` (``intrinsic_dim`` per row), the
observation noise of ``linear_gaussian`` from ``STREAM_OBS``. The fused
kernels draw the same words, so ``intrinsic_dim`` is also the width of the
kernels' manifold draw.

  - ``gaussian``: an isotropic N(0, I_dim) core (``STREAM_MANIFOLD``) and
    ``padding_dim`` padding coordinates of variance ``noise_level``
    (``STREAM_OBS``), zero where either is 0. Its score needs an
    eigendecomposition, which stays on the host (``score_on_host``).
  - ``linear_gaussian``: Y = A·X with X ~ N(0, I_k) and A full-rank
    (dim × k), zero-padded to the ambient dimension, plus optional
    isotropic observation noise of variance ``var_added``.
  - ``sigmoid``: Y = [z, σ(z·A), 0-padding] with z ~ N(0, I_dim) and A a
    (dim × 1) column; ambient dimension dim + 1 + padding.
  - ``sphere``: x = n·rsqrt(max(Σn², 1e-20)) on the first ``dim`` columns
    (the formula the TPU MLP kernel uses, ``mlp_vae.py:239-242``), zero
    padding after.

``A`` is drawn with numpy from the dataset seed. The JAX package draws it
with threefry, which this port does not reproduce, so ``create`` also
accepts an injected ``A``: the parity tests pass in the JAX dataset's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import rng
from .base import DistributionDataset, pad_with_zeros, padding_energy


class GaussianDataset(DistributionDataset):
    """Isotropic gaussian with optional noisy padding dimensions (the
    reference defines it but never wires it to its CLI; ``--dataset
    gaussian`` reaches it here, as in the JAX package)."""

    var_added = 0.0  # no observation noise on the core
    # the score's eigendecomposition runs on the host: the engine hands the
    # generated batch back (``score_host``) instead of scoring on the device
    score_on_host = True

    def __init__(self, dim: int = 3, padding_dim: int = 0, noise_level: float = 0.01,
                 device="cpu"):
        self.dim = dim
        self.padding_dim = padding_dim
        self.noise_level = float(noise_level)
        self._pad_scale = float(np.sqrt(np.float32(self.noise_level)))
        self._device = torch.device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def intrinsic_dim(self) -> int:
        return self.dim

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim

    def sample(self, seed: int, step, n: int) -> torch.Tensor:
        """(n, ndim) batch at counter ``step``: the core from
        STREAM_MANIFOLD, the padding from STREAM_OBS scaled by
        √noise_level (zeros when either the noise or the padding is 0)."""
        core = rng.normals(seed, step, n, rng.STREAM_MANIFOLD, self.dim, device=self.device)
        if self.noise_level > 0 and self.padding_dim > 0:
            pad = rng.normals(seed, step, n, rng.STREAM_OBS, self.padding_dim,
                              device=self.device)
            return torch.cat([core, pad * self._pad_scale], dim=1)
        return pad_with_zeros(core, self.padding_dim)

    def score(self, batch: torch.Tensor) -> Dict[str, np.ndarray]:
        return self.score_host(batch.detach().cpu().numpy())

    def score_host(self, batch: np.ndarray) -> Dict[str, np.ndarray]:
        """The padding's mean squared norm (a float) and the eigenvalues of
        the batch's covariance against the ground truth's (all ones), with
        numpy's ``eigh`` on the host."""
        padding = batch[:, self.dim:]
        mse = float(np.mean(np.sum(np.square(padding), axis=1)))
        w_ht = np.linalg.eigh(np.atleast_2d(np.cov(batch.T)))[0]
        return {
            "Squared Norm of padding dimensions": mse,
            "ground truth eigenvalue": np.ones_like(w_ht),
            "learnt eigenvalue": w_ht,
        }

    def plot_batch(self, batch, fn=None) -> bool:
        """Sorted-norm curve (2-D scatter for dim 2); False where matplotlib
        is not installed."""
        return _plot_scatter_or_norms(self, batch, fn)


def _plot_scatter_or_norms(dataset, batch, fn) -> bool:
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    b = np.asarray(batch.detach().cpu()) if isinstance(batch, torch.Tensor) else np.asarray(batch)
    if dataset.dim == 2:
        plt.scatter(b[:, 0], b[:, 1])
    else:
        plt.plot(np.sort(np.linalg.norm(b, axis=1)))
        plt.ylabel("Norm of points")
    plt.title(f"Gaussian with dimension {dataset.dim} and padding {dataset.padding_dim}")
    if fn is not None:
        plt.savefig(fn)
    plt.close()
    return True


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
        self._obs_scale = float(np.sqrt(np.float32(self.var_added)))

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

    def sample(self, seed: int, step, n: int) -> torch.Tensor:
        """(n, ndim) batch at counter ``step`` of the stream keyed ``seed``:
        intrinsic normals from STREAM_MANIFOLD, observation noise from
        STREAM_OBS."""
        lat = rng.normals(seed, step, n, rng.STREAM_MANIFOLD,
                          self.intrinsic_dim, device=self.device)
        y = pad_with_zeros(lat @ self.A.T, self.padding_dim)
        if self.var_added > 0:
            noise = rng.normals(seed, step, n, rng.STREAM_OBS, self.ndim,
                                device=self.device)
            y = y + noise * self._obs_scale
        return y

    def score(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"Squared Norm of padding dimensions":
                padding_energy(batch[:, self.dim:])}

    def plot_batch(self, batch, fn=None) -> bool:
        """Sorted-norm curve (2-D scatter for dim 2); skipped, returning
        False, where matplotlib is not installed."""
        return _plot_scatter_or_norms(self, batch, fn)


class SigmoidDataset(DistributionDataset):
    """Y = [z, σ(z·A), 0-padding] with z ~ N(0, I_dim), A a (dim × 1) column."""

    var_added = 0.0  # no observation noise on this manifold

    def __init__(self, A: torch.Tensor, dim: int, padding_dim: int = 0):
        if tuple(A.shape) != (dim, 1):
            raise ValueError(f"A must be ({dim}, 1), got {tuple(A.shape)}")
        self.A = A.to(torch.float32)
        self.dim = dim
        self.padding_dim = padding_dim

    @classmethod
    def create(cls, seed: int, dimension: int = 3, padding_dimension: int = 0,
               A: Optional[np.ndarray] = None, device="cpu") -> "SigmoidDataset":
        if A is None:
            A = np.random.default_rng(seed).standard_normal((dimension, 1))
        A = torch.tensor(np.asarray(A, np.float32), device=device)
        return cls(A, dimension, padding_dimension)

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def intrinsic_dim(self) -> int:
        return self.dim

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim + 1

    def sample(self, seed: int, step, n: int) -> torch.Tensor:
        z = rng.normals(seed, step, n, rng.STREAM_MANIFOLD, self.dim,
                        device=self.device)
        out = torch.cat([z, torch.sigmoid(z @ self.A)], dim=1)
        return pad_with_zeros(out, self.padding_dim)

    def score(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        # The published metric's two quirks, kept as the JAX package keeps
        # them (vae_training_tpu/data/synthetic.py:267-290): the σ-coordinate
        # is compared with the pre-sigmoid logit z·A, and the reference's
        # (n,) − (n,1) broadcast makes the mean run over all n² cross pairs,
        # computed here in the same closed form:
        # mean(ĉ²) − 2·mean(ĉ)·mean(c) + mean(c²).
        codomain_hat = batch[:, self.dim]
        codomain = (batch[:, :self.dim] @ self.A)[:, 0]
        manifold_error = (torch.mean(torch.square(codomain_hat))
                          - 2.0 * torch.mean(codomain_hat) * torch.mean(codomain)
                          + torch.mean(torch.square(codomain)))
        return {
            "Squared Norm of Padding Dimensions": padding_energy(batch[:, self.dim + 1:]),
            "Squared Norm of Manifold Dimension": manifold_error,
        }

    def plot_batch(self, batch, fn=None) -> bool:
        """The σ-coordinate against the logit, for the batch and a true
        sample of the same size; False where matplotlib is not installed."""
        try:
            import matplotlib
        except ImportError:
            return False
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        true_batch = self.sample(0, 0, batch.shape[0])
        for b in (batch, true_batch):
            b = b.detach()
            plt.scatter(np.asarray((b[:, :self.dim] @ self.A).cpu()),
                        np.asarray(b[:, self.dim].cpu()))
        if fn is not None:
            plt.savefig(fn)
        plt.close()
        return True


class SphereDataset(DistributionDataset):
    """Uniform samples on S^{dim-1}, zero-padded to the ambient dimension."""

    var_added = 0.0  # no observation noise on this manifold

    def __init__(self, dim: int = 3, padding_dim: int = 0, device="cpu"):
        self.dim = dim
        self.padding_dim = padding_dim
        self._device = torch.device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def intrinsic_dim(self) -> int:
        return self.dim

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim

    def sample(self, seed: int, step, n: int) -> torch.Tensor:
        g = rng.normals(seed, step, n, rng.STREAM_MANIFOLD, self.dim,
                        device=self.device)
        norm2 = torch.sum(g * g, dim=1, keepdim=True)
        return pad_with_zeros(g * torch.rsqrt(torch.clamp(norm2, min=1e-20)),
                              self.padding_dim)

    def score(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        # (‖x‖ − 1)² on the sphere's coordinates; squared norm of the padding
        sphere_err = torch.mean(torch.square(
            torch.linalg.vector_norm(batch[:, :self.dim], dim=1) - 1.0))
        pad_err = torch.mean(torch.square(
            torch.linalg.vector_norm(batch[:, self.dim:], dim=1)))
        return {"Sphere Error": sphere_err, "Padding Error": pad_err}

    def plot_batch(self, batch, fn=None) -> bool:
        """Histogram of the norms; False where matplotlib is not installed."""
        try:
            import matplotlib
        except ImportError:
            return False
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        norms = np.linalg.norm(np.asarray(batch.detach().cpu()), axis=1)
        plt.hist(norms, bins=[0.1 * i for i in range(13)])
        if fn is not None:
            plt.savefig(fn)
        plt.close()
        return True
