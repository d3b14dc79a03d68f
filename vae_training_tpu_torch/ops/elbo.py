"""Closed-form gaussian ELBO decomposition.

Port of ``vae_training_tpu/ops/elbo.py:53-89``. Semantics kept exactly:
``epsilon`` is a log-variance (decoder stdev e^{ε/2}); the posterior
log-variance ``logvar_e`` is a global learned vector broadcast across the
batch; the reconstruction term carries the gaussian normalisation constant
0.5·(log 2π + ε) per output dimension.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

LOG_2PI = math.log(2.0 * math.pi)


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
