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

``EpochChunk`` is epoch mode's chunk (an image corpus, the JAX package's
``make_epoch_chunk``, ``step.py:188-307``): one epoch over a Philox
permutation of the corpus, read through ``EpochBatches``, a dataset whose
``sample`` returns the step's minibatch of the permutation, so the same two
chunks train it, the graph holding a whole epoch
(``tests/test_torch_epoch.py``; ``chip_smoke.py`` phases 43-48).

This path is also the plain twin of the fused kernels
(``kernels/linear_vae.py``, ``kernels/mlp_vae.py``): their hand-derived
backwards are held against autograd here. ``--kernels torch`` runs it on
any device.
"""

from __future__ import annotations

import contextlib
from dataclasses import replace
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.base import DistributionDataset
from ..models.networks import VAE
from ..ops import elbo_terms, rng
from ..utils.spans import span
from .state import TrainState, adam_update_

# external noise for a chunk: (x, z1, z2), each (n_steps, batch, dim)
Noise = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# external noise for an epoch: (perm, z1, z2), the corpus order (n,) and
# z1, z2 (n_batches, batch, dim)
EpochNoise = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def sample_z(seed: int, step, n: int, latent_dim: int, data_dim: int,
             device=None, row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior draw at counter ``step`` (an int or a device int64 tensor):
    z1 (n, latent_dim) for the reparameterisation and z2 (n, data_dim) for
    the decoder output noise, rows ``row0 .. row0 + n − 1`` of the draw
    (a data-parallel rank's shard, ``parallel/dp.py``)."""
    z1 = rng.normals(seed, step, n, rng.STREAM_Z1, latent_dim, device=device, row0=row0)
    z2 = rng.normals(seed, step, n, rng.STREAM_Z2, data_dim, device=device, row0=row0)
    return z1, z2


def loss_terms(model: VAE, params, x, z1, z2):
    """(loss, dkl, mse, logvar_e, epsilon) of the model bound to ``params``."""
    x_hat, mu, logvar_e, epsilon = functional_call(model, params, (x, z1, z2))
    loss, dkl, mse = elbo_terms(x, x_hat, mu, logvar_e, epsilon)
    return loss, dkl, mse, logvar_e, epsilon


def step_body(model: VAE, dataset: DistributionDataset, state: TrainState, step, count,
              *, batch_size: int, lr: float, noise: Optional[Noise] = None,
              dp=None) -> torch.Tensor:
    """One step in place on the state's parameters and moments: the draw at
    counter ``step`` (or the caller's ``noise``, one step's (x, z1, z2)),
    the ELBO, its gradients by autograd and Adam at the post-increment
    ``count``. ``step`` and ``count`` are Python ints or device int64
    tensors, with the same result. Returns the detached 0-d loss; the
    parameters must require grad.

    A data-parallel rank passes ``dp`` (``parallel/dp.py``
    ``DataParallel``): it draws its shard of the global batch of
    ``batch_size`` rows, ``dp.local_batch`` rows from ``dp.row0`` (a
    ``noise`` hook then holds that shard), ``dp.loss`` computes the loss
    (``parallel/gspmd.py`` shards the model's layers there), and
    ``dp.reduce`` maps (gradients, loss) to their means over the ranks
    before Adam."""
    params = state.params
    row0 = 0 if dp is None else dp.row0
    batch_size = batch_size if dp is None else dp.local_batch
    if noise is not None:
        x, z1, z2 = noise
    else:
        device = next(iter(params.values())).device
        x = dataset.sample(state.data_seed, step, batch_size, row0=row0)
        z1, z2 = sample_z(state.model_seed, step, batch_size, model.latent_dim,
                          dataset.dimension, device, row0=row0)
    loss = (loss_terms(model, params, x, z1, z2)[0] if dp is None
            else dp.loss(model, params, x, z1, z2))
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    if dp is not None:
        grads, loss = dp.reduce(grads, loss)
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
                noise: Optional[Noise] = None, dp=None) -> Tuple[TrainState, torch.Tensor]:
    """Run ``n_steps`` autograd + Adam steps, op by op. Returns the
    advanced state and the (n_steps,) per-step losses.

    The state's parameter and moment tensors are updated in place (the JAX
    chunk donates its buffers the same way). ``noise`` replaces the
    sampler with caller-supplied (x, z1, z2) per step, the test hook the
    fused kernel shares. ``dp``: a data-parallel rank's shard and
    reduction (``step_body``)."""
    train_chunk.calls += 1
    params = state.params
    device = next(iter(params.values())).device
    losses = torch.empty(n_steps, dtype=torch.float32, device=device)
    with _requiring_grad(params):
        for i in range(n_steps):
            losses[i] = step_body(model, dataset, state, state.step + i, state.count + i + 1,
                                  batch_size=batch_size, lr=lr, dp=dp,
                                  noise=None if noise is None else tuple(t[i] for t in noise))
    return replace(state, step=state.step + n_steps,
                   count=state.count + n_steps), losses


train_chunk.calls = 0  # chunks run op by op (chip_smoke reads it)


def counter_step_(model: VAE, dataset: DistributionDataset, state: TrainState,
                  counters: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  losses: torch.Tensor, *, batch_size: int, lr: float, dp=None) -> None:
    """``GraphChunk``'s step: ``step_body`` at the device counters (step,
    post-increment Adam count, loss index; int64 0-d tensors), the loss
    written to ``losses[index]``, every counter advanced by one. Nothing
    in it reads a tensor on the host, so a CUDA graph captures it; on the
    CPU it runs eagerly (the tests hold it to ``train_chunk``)."""
    step, count, index = counters
    loss = step_body(model, dataset, state, step, count, batch_size=batch_size, lr=lr, dp=dp)
    losses.index_copy_(0, index.view(1), loss.view(1))
    for t in counters:
        t.add_(1)


class GraphChunk:
    """``train_chunk`` on the card: ``counter_step_`` captured once as a CUDA
    graph and replayed ``n_steps`` times a chunk (one graph a step, not a
    chunk, because the chunk lengths vary with the events). With
    ``steps_per_replay`` k the graph holds k steps and a chunk is a whole
    number of replays: ``EpochChunk`` captures an epoch, whose length is
    fixed (9.5–13.4% less wall time a step than one replay a step at the
    bench's conv configuration on an H100 80GB HBM3 at 700 W, PERF.md).

    The graph reads the parameters, moments, counters and loss buffer at
    the addresses it captured. It is captured at the first chunk, after
    the caller has made its state final (``--resume``, ``--state_dict``),
    and again whenever a chunk's state holds other tensors (``data_ptr``),
    other seeds, or more steps than the loss buffer. The warm-up steps that
    capture needs run on the real tensors, which are then restored, so the
    chunk starts from the state it was given. A failed capture raises.
    With an external ``noise`` hook a chunk runs ``train_chunk`` instead.

    With ``dp`` (a data-parallel rank, ``step_body``) the graph holds the
    step's all-reduces too: NCCL collectives are captured, and the capture
    checks only this thread's CUDA calls (``capture_error_mode=
    "thread_local"``), so that the NCCL watchdog's event queries on its own
    thread do not void it."""

    calls = 0  # chunks run as graph replays (chip_smoke reads it)
    WARMUP = 3

    def __init__(self, model: VAE, dataset: DistributionDataset, *, batch_size: int,
                 lr: float, steps_per_replay: int = 1, dp=None):
        self.model, self.dataset = model, dataset
        self.batch_size, self.lr = batch_size, lr
        self.steps_per_replay = steps_per_replay
        self.dp = dp
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
                               batch_size=self.batch_size, lr=self.lr, noise=noise,
                               dp=self.dp)
        k = self.steps_per_replay
        if n_steps % k:
            raise ValueError(f"a chunk of {n_steps} steps is not a whole number of "
                             f"{k}-step graph replays")
        GraphChunk.calls += 1
        if (self._graph is None or self._key != self._key_of(state)
                or n_steps > self._losses.numel()):
            self._capture(state, max(n_steps, k))
        step, count, index = self._counters
        step.fill_(state.step)
        count.fill_(state.count + 1)
        index.zero_()
        for _ in range(n_steps // k):
            self._graph.replay()
        return (replace(state, step=state.step + n_steps, count=state.count + n_steps),
                self._losses[:n_steps].clone())

    def _capture(self, state: TrainState, n_steps: int) -> None:
        device = next(iter(state.params.values())).device
        if device.type != "cuda":
            raise ValueError(f"GraphChunk needs a state on a CUDA device, not {device}")
        self._graph = None  # the old graph's memory pool goes first
        # the warm-up runs whole graph bodies, at least WARMUP steps; the loss
        # buffer is a power of two (longer chunks recapture rarely) with room
        # for the warm-up steps' losses
        k = self.steps_per_replay
        warm_bodies = -(-self.WARMUP // k)
        capacity = max(1 << (n_steps - 1).bit_length(), warm_bodies * k)
        self._losses = torch.zeros(capacity, dtype=torch.float32, device=device)
        self._counters = tuple(torch.zeros((), dtype=torch.int64, device=device)
                               for _ in range(3))
        self._counters[0].fill_(state.step)
        self._counters[1].fill_(state.count + 1)
        held = [t for d in (state.params, state.m, state.v) for t in d.values()]
        saved = [t.clone() for t in held]

        def body():
            for _ in range(k):
                counter_step_(self.model, self.dataset, state, self._counters, self._losses,
                              batch_size=self.batch_size, lr=self.lr, dp=self.dp)

        graph = torch.cuda.CUDAGraph()
        mode = "global" if self.dp is None else "thread_local"
        try:
            with _requiring_grad(state.params):
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    for _ in range(warm_bodies):
                        body()
                torch.cuda.current_stream(device).wait_stream(side)
                with torch.cuda.graph(graph, capture_error_mode=mode):
                    body()
        finally:
            with torch.no_grad():
                for t, s in zip(held, saved):
                    t.copy_(s)
        self._graph, self._key, self._held = graph, self._key_of(state), held


class EpochBatches:
    """An image corpus read in one epoch's order, with the dataset
    interface the chunks use: ``sample(seed, step, n)`` is minibatch
    ``step − step0`` of the epoch's permutation (``seed`` is unused: the
    permutation carries the randomness). ``step`` is a Python int or a
    device int64 tensor, with the same batch; the permutation and ``step0``
    live in buffers that ``set_epoch`` overwrites in place, so one CUDA
    graph serves every epoch. The corpus is kept flat, (n, h·w·c) in NHWC
    order, as the ELBO reads it; the conv VAE reshapes its input."""

    def __init__(self, images: torch.Tensor, batch_size: int):
        self.corpus = images.reshape(images.shape[0], -1)
        self.batch_size = batch_size
        self.n_batches = images.shape[0] // batch_size
        if self.n_batches == 0:
            raise ValueError("batch_size exceeds the dataset size")
        device = images.device
        self.perm = torch.zeros(self.n_batches * batch_size, dtype=torch.int64, device=device)
        self.step0 = 0
        self._step0 = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def dimension(self) -> int:
        return self.corpus.shape[1]

    def set_epoch(self, perm: torch.Tensor, step0: int) -> None:
        """Take the epoch's permutation (the first n_batches · batch_size
        indices are used; the leftover images are dropped) and its first
        step."""
        self.perm.copy_(perm[:self.perm.numel()])
        self.step0 = step0
        self._step0.fill_(step0)

    def sample(self, seed: int, step, n: int, row0: int = 0) -> torch.Tensor:
        """Minibatch ``step − step0``, or its rows ``row0 .. row0 + n − 1``:
        a data-parallel rank's slice ``perm[i·B + row0 : i·B + row0 + n]``
        (the JAX package's ``step.py:245-256``)."""
        b = self.batch_size
        if row0 < 0 or n < 1 or row0 + n > b:
            raise ValueError(f"an epoch's minibatch is {b} images, not rows "
                             f"{row0}..{row0 + n - 1}")
        if isinstance(step, torch.Tensor):
            i = (step - self._step0).view(1)
            idx = self.perm.view(self.n_batches, b).index_select(0, i).view(b)[row0:row0 + n]
        else:
            i = step - self.step0
            idx = self.perm[i * b + row0:i * b + row0 + n]
        return self.corpus.index_select(0, idx)


class EpochChunk:
    """One epoch of an image corpus as one chunk: the counterpart of the
    JAX package's ``make_epoch_chunk`` without a mesh (``step.py:188-307``).

    ``chunk(state, epoch, n_batches=None, noise=None)`` trains on the
    epoch's permutation (``dataset.epoch_permutation(state.data_seed,
    epoch)``), step i on its slice i (``n // batch_size`` steps, the
    leftover images dropped), with z1, z2 from the Philox streams at the
    step (``sample_z``, the counterpart of ``fold_in(model_key, step)``),
    and returns the advanced state and the (n_batches,) losses. ``noise``
    is the test hook ``(perm, z1s, z2s)``: the caller's permutation and
    (n_batches, batch, dim) noise. ``graph`` picks the form: one CUDA graph
    replay an epoch (``GraphChunk`` with ``steps_per_replay`` = the epoch's
    steps; the permutation is copied into the graph's static buffer before
    the replay; a graph epoch is always whole) or op by op (``train_chunk``,
    which a noise hook always takes).

    With ``dp`` (the JAX package's mesh branch, ``step.py:223-305``) rank
    r of the data axes trains on ``perm[i·B + r·lb : i·B + (r+1)·lb]`` of
    step i, its noise from row ``r·lb`` of the step's draw, the gradients
    and the loss all-reduced as means; a noise hook's z1s, z2s are then the
    rank's (n_batches, lb, dim) shard."""

    def __init__(self, model: VAE, dataset, *, batch_size: int, lr: float, graph: bool,
                 dp=None):
        self.model, self.dataset = model, dataset
        self.batches = EpochBatches(dataset.images, batch_size)
        self.batch_size = batch_size
        self.dp = dp
        kw = dict(batch_size=batch_size, lr=lr, dp=dp)
        self._chunk = (GraphChunk(model, self.batches, steps_per_replay=self.batches.n_batches,
                                  **kw) if graph
                       else partial(train_chunk, model, self.batches, **kw))

    def __call__(self, state: TrainState, epoch: int, n_batches: Optional[int] = None,
                 noise: Optional[EpochNoise] = None) -> Tuple[TrainState, torch.Tensor]:
        nb = self.batches.n_batches if n_batches is None else n_batches
        if not 0 < nb <= self.batches.n_batches:
            raise ValueError(f"an epoch has 1 to {self.batches.n_batches} steps, not {nb}")
        perm = (self.dataset.epoch_permutation(state.data_seed, epoch) if noise is None
                else noise[0])
        self.batches.set_epoch(perm, state.step)
        if noise is None:
            return self._chunk(state, nb)
        n, row0 = ((self.batch_size, 0) if self.dp is None
                   else (self.dp.local_batch, self.dp.row0))
        xs = torch.stack([self.batches.sample(state.data_seed, state.step + i, n, row0)
                          for i in range(nb)])
        return self._chunk(state, nb, noise=(xs, noise[1], noise[2]))


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
    with span("eval.draw"):
        real = dataset.sample(data_seed, counter, n)
        z1, z2 = sample_z(z_seed, counter, n, model.latent_dim, dataset.dimension,
                          real.device)
    with span("eval.forward"):
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
