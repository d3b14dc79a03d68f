"""Dataset abstractions: counter-keyed samplers with analytic scoring.

Port of ``vae_training_tpu/data/base.py:26-118``. Where the JAX dataset is
an immutable pytree sampled with caller-owned ``jax.random`` keys, a port
dataset is a plain object sampled with a caller-owned 64-bit seed and a
counter: ``sample(seed, step, n)`` is a pure function of its arguments
(``ops/rng.py``), which is what keeps resume bit-exact.
"""

from __future__ import annotations

from typing import Dict

import torch


class DistributionDataset:
    """An infinite sampler over a known manifold, with analytic scoring.

    Subclasses implement ``sample(seed, step, n, row0=0)``,
    ``score(batch)``, ``plot_batch(batch, fn)`` and the ``ndim`` property.
    ``step`` is a Python int or a device int64 tensor (the CUDA-graph
    chunk's counter, ``train/step.py``), with the same batch either way; a
    sample runs only device work (no ``.item()``, no numpy), so a graph can
    capture it. ``row0`` is the first row of the global batch that the
    sample is: a data-parallel rank draws rows ``row0 .. row0 + n − 1`` of
    the one-device batch (``parallel/dp.py``)."""

    is_epochs = False  # an infinite sampler: the engine's step loop, not epochs
    # the manifold dots' mode (config.bf16_dots): bf16 operands, f32 sums
    bf16_dots = False

    @property
    def ndim(self) -> int:
        raise NotImplementedError

    @property
    def shape(self) -> tuple:
        return (self.ndim,)

    @property
    def dimension(self) -> int:
        d = 1
        for s in self.shape:
            d *= int(s)
        return d

    def sample(self, seed: int, step, n: int, row0: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def score(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def plot_batch(self, batch, fn=None) -> bool:
        """Write a diagnostic figure; False when it was skipped."""
        raise NotImplementedError

    def host_copy(self) -> "DistributionDataset":
        """What ``save`` reads, on the host: taken when a save is submitted,
        written by the background writer (the live datasets hold nothing
        to write)."""
        return self

    def save(self, fn: str) -> None:
        """The reference's manifold persistence, a no-op for the live
        datasets (``vae_training_tpu/data/base.py:97-101``); an image
        corpus writes ``fn + ".npz"``."""

    def load(self, fn: str):
        """--data_fn hook: a persisted manifold (none for the live datasets)."""
        return self


def pad_with_zeros(x: torch.Tensor, padding_dim: int) -> torch.Tensor:
    """Append ``padding_dim`` zero ambient dimensions to (n, d) samples."""
    if padding_dim == 0:
        return x
    return torch.nn.functional.pad(x, (0, padding_dim))


def padding_energy(padding: torch.Tensor) -> torch.Tensor:
    """Mean squared norm of the padding coordinates."""
    return torch.mean(torch.sum(torch.square(padding), dim=1))
