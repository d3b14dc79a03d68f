"""The torch path: plain PyTorch training chunk, eval and generation.

Port of ``vae_training_tpu/train/step.py:84-185``. The JAX package runs a
chunk as one ``lax.scan`` program; here ``train_chunk`` is a Python loop of
autograd steps. Per step it draws the batch and the prior noise from the
counter-keyed Philox streams (``ops/rng.py``), computes the ELBO with the
model bound to the state's parameters (``torch.func.functional_call``),
takes the gradients with autograd, and applies the explicit Adam update.

This path is the plain twin of the fused kernels (``kernels/linear_vae.py``,
``kernels/mlp_vae.py``): their hand-derived backwards are held against
autograd here. ``--kernels torch`` runs it on any device.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.base import DistributionDataset
from ..models.networks import VAE
from ..ops import elbo_terms, rng
from .state import TrainState, adam_update_

# external noise for a chunk: (x, z1, z2), each (n_steps, batch, dim)
Noise = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def sample_z(seed: int, step: int, n: int, latent_dim: int, data_dim: int,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior draw at counter ``step``: z1 (n, latent_dim) for the
    reparameterisation and z2 (n, data_dim) for the decoder output noise."""
    z1 = rng.normals(seed, step, n, rng.STREAM_Z1, latent_dim, device=device)
    z2 = rng.normals(seed, step, n, rng.STREAM_Z2, data_dim, device=device)
    return z1, z2


def loss_terms(model: VAE, params, x, z1, z2):
    """(loss, dkl, mse, logvar_e, epsilon) of the model bound to ``params``."""
    x_hat, mu, logvar_e, epsilon = functional_call(model, params, (x, z1, z2))
    loss, dkl, mse = elbo_terms(x, x_hat, mu, logvar_e, epsilon)
    return loss, dkl, mse, logvar_e, epsilon


def train_chunk(model: VAE, dataset: DistributionDataset, state: TrainState,
                n_steps: int, *, batch_size: int, lr: float,
                noise: Optional[Noise] = None) -> Tuple[TrainState, torch.Tensor]:
    """Run ``n_steps`` autograd + Adam steps. Returns the advanced state and
    the (n_steps,) per-step losses.

    The state's parameter and moment tensors are updated in place (the JAX
    chunk donates its buffers the same way). ``noise`` replaces the
    sampler with caller-supplied (x, z1, z2) per step, the test hook the
    fused kernel shares."""
    train_chunk.calls += 1
    names = list(state.params)
    params = state.params
    device = params[names[0]].device
    losses = torch.empty(n_steps, dtype=torch.float32, device=device)
    for p in params.values():
        p.requires_grad_(True)
    try:
        for i in range(n_steps):
            step = state.step + i
            if noise is not None:
                x, z1, z2 = (t[i] for t in noise)
            else:
                x = dataset.sample(state.data_seed, step, batch_size)
                z1, z2 = sample_z(state.model_seed, step, batch_size,
                                  model.latent_dim, dataset.dimension, device)
            loss = loss_terms(model, params, x, z1, z2)[0]
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            count = state.count + i + 1
            for k, g in zip(names, grads):
                adam_update_(params[k], state.m[k], state.v[k], g, count, lr)
            losses[i] = loss.detach()
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return replace(state, step=state.step + n_steps,
                   count=state.count + n_steps), losses


train_chunk.calls = 0  # chunks run on the plain path (chip_smoke reads it)


@torch.no_grad()
def generate(model: VAE, params, z1, z2, epsilon) -> torch.Tensor:
    return functional_call(model, params, (None, z1, z2, epsilon))


@torch.no_grad()
def eval_step(model: VAE, dataset: DistributionDataset, params,
              data_seed: int, z_seed: int, counter: int, epsilon,
              n: int = 1000) -> Dict[str, torch.Tensor]:
    """One eval pass: a real batch and a prior draw at counter ``counter``,
    the ELBO decomposition on the real batch, and the dataset's analytic
    score of a generated batch (decoded with the caller's ``epsilon``). A
    dataset that scores on the host (``score_on_host``) gets the generated
    batch back as ``_fake`` instead, for ``eval_to_host``."""
    real = dataset.sample(data_seed, counter, n)
    z1, z2 = sample_z(z_seed, counter, n, model.latent_dim, dataset.dimension,
                      real.device)
    fake = generate(model, params, z1, z2, epsilon)
    loss, dkl, mse, logvar_e, eps_out = loss_terms(model, params, real, z1, z2)
    out = {"VAE Loss": loss, "KL divergence": dkl, "mse": mse,
           "_logvar_e": logvar_e, "_epsilon": eps_out}
    if getattr(dataset, "score_on_host", False):
        out["_fake"] = fake
    else:
        out.update(sorted_scores(dataset.score(fake)))
    return out


def eval_to_host(dataset: DistributionDataset, out: Dict[str, torch.Tensor]
                 ) -> Tuple[dict, np.ndarray, np.ndarray]:
    """``eval_step``'s output on the host: (stats, logvar_e, epsilon), the
    stats as numpy copies (``logvar_e`` is the live ``epsilon_p``, which
    later steps update in place), a host-scored dataset's scores computed
    from the generated batch, in sorted key order."""
    out = {k: v.detach().cpu().numpy().copy() for k, v in out.items()}
    logvar_e, epsilon = out.pop("_logvar_e"), out.pop("_epsilon")
    fake = out.pop("_fake", None)
    if fake is not None:
        out.update(sorted_scores(dataset.score_host(fake)))
    return out, logvar_e, epsilon


def sorted_scores(scores: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A dataset's scores in sorted key order, the order in which the JAX
    engine's jitted programs return them (jit sorts a dict's keys); the
    console columns, ``losses.npz`` and the banner all follow it. The
    dataset's own ``score`` keeps the unjitted insertion order."""
    return {k: scores[k] for k in sorted(scores)}


def banner_scores(dataset: DistributionDataset, batch: torch.Tensor) -> Dict[str, np.ndarray]:
    """The "Score for real data" values as the JAX engine prints them: sorted
    keys, each a 0-d float32 array (``array(0., dtype=float32)``); a
    host-scored dataset's ``score_host`` values as they come (a float and
    float64 arrays)."""
    if getattr(dataset, "score_on_host", False):
        return sorted_scores(dataset.score_host(batch.detach().cpu().numpy()))
    return {k: np.asarray(v.detach().cpu().numpy(), np.float32)
            for k, v in sorted_scores(dataset.score(batch)).items()}
