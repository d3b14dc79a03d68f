"""The torch path: plain PyTorch training chunk, eval and generation.

Port of ``vae_training_tpu/train/step.py:84-185``. One step (``step_body``)
draws the batch and the prior noise from the counter-keyed Philox streams
(``ops/rng.py``), computes the ELBO with the model bound to the state's
parameters (``torch.func.functional_call``), takes the gradients with
autograd, and applies the explicit Adam update in place.

Two chunks drive that body. ``train_chunk`` is a Python loop of it, with
the step and the Adam count as Python ints: the plain version, run on the
CPU, under ``-nojit`` and ``--debug_nans``, and with an external noise
hook. ``GraphChunk`` is the card's form, the counterpart of the JAX
package's one ``lax.scan`` program a chunk (``step.py:114-119``): the same
body with the step, the count and the loss index held in device tensors
(``counter_step_``), captured once as a CUDA graph and replayed once a
step, so a step costs one graph launch instead of hundreds of op
dispatches. Both give the same losses and state (``tests/
test_torch_graph_chunk.py``; ``chip_smoke.py`` phase 40 on the card).

This path is also the plain twin of the fused kernels
(``kernels/linear_vae.py``, ``kernels/mlp_vae.py``): their hand-derived
backwards are held against autograd here. ``--kernels torch`` runs it on
any device.
"""

from __future__ import annotations

import contextlib
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


def sample_z(seed: int, step, n: int, latent_dim: int, data_dim: int,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior draw at counter ``step`` (an int or a device int64 tensor):
    z1 (n, latent_dim) for the reparameterisation and z2 (n, data_dim) for
    the decoder output noise."""
    z1 = rng.normals(seed, step, n, rng.STREAM_Z1, latent_dim, device=device)
    z2 = rng.normals(seed, step, n, rng.STREAM_Z2, data_dim, device=device)
    return z1, z2


def loss_terms(model: VAE, params, x, z1, z2):
    """(loss, dkl, mse, logvar_e, epsilon) of the model bound to ``params``."""
    x_hat, mu, logvar_e, epsilon = functional_call(model, params, (x, z1, z2))
    loss, dkl, mse = elbo_terms(x, x_hat, mu, logvar_e, epsilon)
    return loss, dkl, mse, logvar_e, epsilon


def step_body(model: VAE, dataset: DistributionDataset, state: TrainState, step, count,
              *, batch_size: int, lr: float, noise: Optional[Noise] = None) -> torch.Tensor:
    """One step in place on the state's parameters and moments: the draw at
    counter ``step`` (or the caller's ``noise``, one step's (x, z1, z2)),
    the ELBO, its gradients by autograd and Adam at the post-increment
    ``count``. ``step`` and ``count`` are Python ints or device int64
    tensors, with the same result. Returns the detached 0-d loss; the
    parameters must require grad."""
    params = state.params
    if noise is not None:
        x, z1, z2 = noise
    else:
        device = next(iter(params.values())).device
        x = dataset.sample(state.data_seed, step, batch_size)
        z1, z2 = sample_z(state.model_seed, step, batch_size, model.latent_dim,
                          dataset.dimension, device)
    loss = loss_terms(model, params, x, z1, z2)[0]
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    for k, g in zip(names, grads):
        adam_update_(params[k], state.m[k], state.v[k], g, count, lr)
    return loss.detach()


@contextlib.contextmanager
def _requiring_grad(params):
    for p in params.values():
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in params.values():
            p.requires_grad_(False)


def train_chunk(model: VAE, dataset: DistributionDataset, state: TrainState,
                n_steps: int, *, batch_size: int, lr: float,
                noise: Optional[Noise] = None) -> Tuple[TrainState, torch.Tensor]:
    """Run ``n_steps`` autograd + Adam steps, op by op. Returns the
    advanced state and the (n_steps,) per-step losses.

    The state's parameter and moment tensors are updated in place (the JAX
    chunk donates its buffers the same way). ``noise`` replaces the
    sampler with caller-supplied (x, z1, z2) per step, the test hook the
    fused kernel shares."""
    train_chunk.calls += 1
    params = state.params
    device = next(iter(params.values())).device
    losses = torch.empty(n_steps, dtype=torch.float32, device=device)
    with _requiring_grad(params):
        for i in range(n_steps):
            losses[i] = step_body(model, dataset, state, state.step + i, state.count + i + 1,
                                  batch_size=batch_size, lr=lr,
                                  noise=None if noise is None else tuple(t[i] for t in noise))
    return replace(state, step=state.step + n_steps,
                   count=state.count + n_steps), losses


train_chunk.calls = 0  # chunks run op by op (chip_smoke reads it)


def counter_step_(model: VAE, dataset: DistributionDataset, state: TrainState,
                  counters: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  losses: torch.Tensor, *, batch_size: int, lr: float) -> None:
    """``GraphChunk``'s step: ``step_body`` at the device counters (step,
    post-increment Adam count, loss index; int64 0-d tensors), the loss
    written to ``losses[index]``, every counter advanced by one. Nothing
    in it reads a tensor on the host, so a CUDA graph captures it; on the
    CPU it runs eagerly (the tests hold it to ``train_chunk``)."""
    step, count, index = counters
    loss = step_body(model, dataset, state, step, count, batch_size=batch_size, lr=lr)
    losses.index_copy_(0, index.view(1), loss.view(1))
    for t in counters:
        t.add_(1)


class GraphChunk:
    """``train_chunk`` on the card: ``counter_step_`` captured once as a CUDA
    graph and replayed ``n_steps`` times a chunk (one graph a step, not a
    chunk, because the chunk lengths vary with the events).

    The graph reads the parameters, moments, counters and loss buffer at
    the addresses it captured. It is captured at the first chunk, after
    the caller has made its state final (``--resume``, ``--state_dict``),
    and again whenever a chunk's state holds other tensors (``data_ptr``),
    other seeds, or more steps than the loss buffer. The warm-up steps that
    capture needs run on the real tensors, which are then restored, so the
    chunk starts from the state it was given. A failed capture raises.
    With an external ``noise`` hook a chunk runs ``train_chunk`` instead."""

    calls = 0  # chunks run as graph replays (chip_smoke reads it)
    WARMUP = 3

    def __init__(self, model: VAE, dataset: DistributionDataset, *, batch_size: int,
                 lr: float):
        self.model, self.dataset = model, dataset
        self.batch_size, self.lr = batch_size, lr
        self._graph = None
        self._key = None

    @staticmethod
    def _key_of(state: TrainState) -> tuple:
        return (state.data_seed, state.model_seed,
                tuple((t.data_ptr(), t.dtype) for d in (state.params, state.m, state.v)
                      for t in d.values()))

    def __call__(self, state: TrainState, n_steps: int, noise: Optional[Noise] = None
                 ) -> Tuple[TrainState, torch.Tensor]:
        if noise is not None:
            return train_chunk(self.model, self.dataset, state, n_steps,
                               batch_size=self.batch_size, lr=self.lr, noise=noise)
        GraphChunk.calls += 1
        if (self._graph is None or self._key != self._key_of(state)
                or n_steps > self._losses.numel()):
            self._capture(state, max(n_steps, 1))
        step, count, index = self._counters
        step.fill_(state.step)
        count.fill_(state.count + 1)
        index.zero_()
        for _ in range(n_steps):
            self._graph.replay()
        return (replace(state, step=state.step + n_steps, count=state.count + n_steps),
                self._losses[:n_steps].clone())

    def _capture(self, state: TrainState, n_steps: int) -> None:
        device = next(iter(state.params.values())).device
        if device.type != "cuda":
            raise ValueError(f"GraphChunk needs a state on a CUDA device, not {device}")
        self._graph = None  # the old graph's memory pool goes first
        # a power of two (longer chunks recapture rarely), and room for the
        # warm-up steps' losses
        capacity = max(1 << (n_steps - 1).bit_length(), self.WARMUP)
        self._losses = torch.zeros(capacity, dtype=torch.float32, device=device)
        self._counters = tuple(torch.zeros((), dtype=torch.int64, device=device)
                               for _ in range(3))
        self._counters[0].fill_(state.step)
        self._counters[1].fill_(state.count + 1)
        held = [t for d in (state.params, state.m, state.v) for t in d.values()]
        saved = [t.clone() for t in held]

        def body():
            counter_step_(self.model, self.dataset, state, self._counters, self._losses,
                          batch_size=self.batch_size, lr=self.lr)

        graph = torch.cuda.CUDAGraph()
        try:
            with _requiring_grad(state.params):
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    for _ in range(self.WARMUP):
                        body()
                torch.cuda.current_stream(device).wait_stream(side)
                with torch.cuda.graph(graph):
                    body()
        finally:
            with torch.no_grad():
                for t, s in zip(held, saved):
                    t.copy_(s)
        self._graph, self._key, self._held = graph, self._key_of(state), held


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


def eval_gradients(model: VAE, dataset: DistributionDataset, params, data_seed: int,
                   z_seed: int, counter: int, n: int = 1000) -> Dict[str, torch.Tensor]:
    """The gradients, by autograd, of the ELBO loss on ``eval_step``'s real
    batch and prior draw at counter ``counter``, keyed like ``params``
    (``--track_correlation``: the JAX engine's unfused eval)."""
    real = dataset.sample(data_seed, counter, n)
    z1, z2 = sample_z(z_seed, counter, n, model.latent_dim, dataset.dimension, real.device)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = loss_terms(model, leaves, real, z1, z2)[0]
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


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
