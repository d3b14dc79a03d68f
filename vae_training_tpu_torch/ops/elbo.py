"""Closed-form gaussian ELBO decomposition.

Port of ``vae_training_tpu/ops/elbo.py:34-89``. Semantics kept exactly:
``epsilon`` is a log-variance (decoder stdev e^{ε/2}); the posterior
log-variance ``logvar_e`` is a global learned vector broadcast across the
batch; the reconstruction term carries the gaussian normalisation constant
0.5·(log 2π + ε) per output dimension.

``binary_cross_entropy`` and ``fill_diagonal`` are the reference's library
helpers (its ``networks.py:16-23``); the live ELBO uses neither.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

LOG_2PI = math.log(2.0 * math.pi)
EPS = 1e-8


def binary_cross_entropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample summed BCE over every axis but the first (the JAX
    package's vmapped form): (n, ...) → (n,)."""
    per = labels * torch.log(probs + EPS) + (1 - labels) * torch.log(1 - probs + EPS)
    return -torch.sum(per.reshape(per.shape[0], -1), dim=1)


def fill_diagonal(a: torch.Tensor, val) -> torch.Tensor:
    """A copy of ``a`` with the leading diagonal of its trailing two dims
    set to ``val``."""
    if a.ndim < 2:
        raise ValueError("fill_diagonal needs ndim >= 2")
    out = a.clone()
    i = torch.arange(min(a.shape[-2:]), device=a.device)
    out[..., i, i] = val
    return out


def kl_to_standard_normal(mu: torch.Tensor, logvar_e: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, diag e^logvar) || N(0, I)), summed over latent dims."""
    return -0.5 * torch.sum(1.0 + logvar_e - torch.exp(logvar_e) - mu * mu, dim=-1)


def gaussian_nll(x: torch.Tensor, x_hat: torch.Tensor,
                 epsilon: torch.Tensor) -> torch.Tensor:
    """Per-sample gaussian negative log-likelihood with log-variance ε."""
    var_d = torch.exp(epsilon)
    per_dim = 0.5 * torch.square(x_hat - x) / var_d + 0.5 * (LOG_2PI + epsilon)
    return torch.sum(per_dim, dim=-1)


def elbo_terms(x: torch.Tensor, x_hat: torch.Tensor, mu: torch.Tensor,
               logvar_e: torch.Tensor, epsilon: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(negative-ELBO mean, KL mean, reconstruction-NLL mean)."""
    dkl = kl_to_standard_normal(mu, logvar_e)
    mse = gaussian_nll(x, x_hat, epsilon)
    return torch.mean(dkl + mse), torch.mean(dkl), torch.mean(mse)
