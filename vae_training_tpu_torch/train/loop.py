"""The training engine: chunked training with host-side cadences.

Port of ``vae_training_tpu/train/loop.py:56-689`` (distribution mode).
Behavioural contract kept:

  - a stat line every ``n_print`` steps, plot + save every ``n_plot`` steps
    and at the last step, eval batch 1000;
  - events fire BEFORE that step's update (the batch-0 eval sees the freshly
    initialised model);
  - the "Score for real data" line at train start, printed as 0-d float32
    arrays; its scores, the stat lines' and ``losses.npz``'s in the JAX
    engine's key order (jit sorts a dict's keys);
  - a tqdm bar on stderr when ``cfg.tqdm`` is set (the CLI sets it, the
    sweep runner's rows do not);
  - per-step training losses recorded (the npz "VAE Loss" trace);
  - between events one ``train_chunk`` covers every intervening step (the
    fused kernel or the torch path, ``kernels/dispatch.py``);
  - saves (losses.npz, model.pkl, the checkpoint; ``--checkpoint_every``'s
    too) are host copies taken at the event and written by the background
    writer (``runio/background.py``); ``train`` returns with every one on
    disk, and ``save(final=True)`` drains it;
  - ``--profile`` traces the first chunk of more than one step with
    ``torch.profiler`` into ``<run>/profile/``;
  - ``--debug_nans`` (the JAX package's ``jax_debug_nans``) raises
    ``FloatingPointError`` naming the step at the first non-finite loss of
    a chunk (read from the host copy the loop makes anyway) or non-finite
    parameter or moment at an eval; the torch path's chunks run under
    ``torch.autograd.detect_anomaly`` (``kernels/dispatch.py``);
  - ``-ws`` applies the dataset's analytic warm start
    (``models/warm_start.py``) after the init and before the state is
    made, as the JAX engine does; ``-wsl`` parses and does nothing, as
    there;
  - ``--track_correlation`` records, at every stat eval, host copies of
    the parameters and of the eval batch's gradients (autograd, whatever
    path trains), carries them in the checkpoint's aux so that a resumed
    run ends with the same history, and writes the correlation ratios
    against the final parameters, whole-tree and per parameter, into the
    final ``losses.npz`` (``utils/trees.py``);
  - ``sample_latent`` / ``sample_batch``: the serving path's prior draw and
    ancestral sampling (``_scripts/sample.py``); ``sample_latent`` and
    ``latent_likelihood`` also take the reference's logistic latent
    (``latent_distribution``, which the CLI forces to gaussian).

``--mesh`` (the JAX engine's ``_build_step_fns`` mesh branch,
``loop.py:168-215, 252-290``) trains through ``kernels/dispatch.py``
``make_parallel_chunk``: the torch path sharded over the ranks
(``parallel/``), the state placed after the init and after
``--resume``/``--state_dict`` (each restore behind ``check_shared_fs``).
Every process runs every event; only the primary prints, draws the
figures and writes (``utils/process.is_primary``); under tensor
parallelism every event first all-gathers the state (``full_state``).

Random streams: the JAX engine splits a host key chain for eval and plot
draws; here every draw is counter-keyed (``ops/rng.py``): eval batches by
the eval counter, plot draws by the step. A resumed run therefore draws
exactly what an uninterrupted one draws, whatever events the interrupted
run fired.

Epoch mode (an image corpus, ``data/images.py``; the JAX engine's
``train_epochs``, ``loop.py:478-516``): ``--arch auto`` builds the conv VAE
(``models/conv.py``) for it and the MLP VAE otherwise, ``--arch conv`` on a
dataset without an (H, W, C) shape raises the JAX engine's message, and
``--arch mlp`` trains the MLP VAE on the flat images. ``train`` runs
``train_epochs``: one ``EpochChunk`` an epoch (``train/step.py``), the
stats, ``Completed Epoch k``, an "Epoch"-labelled stat line, a figure
tagged by the epoch and a save every epoch; the checkpoint's aux carries
``epoch_num``, and a resume continues at epoch ``step // n_batches``.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RunConfig, bf16_dots
from ..data.base import DistributionDataset
from ..evals.stats import StatsRecorder
from ..kernels.dispatch import make_parallel_chunk, make_train_chunk
from ..models.conv import build_conv_vae
from ..models.networks import build_vae
from ..models.warm_start import apply_warm_start
from ..ops import rng
from ..runio.background import get_artifact_writer
from ..runio.checkpoint import (
    checkpoint_exists,
    restore_run,
    save_checkpoint,
    save_checkpoint_dcp,
)
from ..runio.export import load_model_pkl, save_model_pkl
from ..utils.process import check_shared_fs, is_primary
from ..utils.trees import correlation_ratio, correlation_ratio_per_param
from .state import TrainState, moment_dtype
from .step import (banner_scores, eval_gradients, eval_step, eval_to_host, generate,
                   sample_z)

N_PLOT = 50000
N_PRINT = 5000
EVAL_BATCH_SIZE = 1000


def next_event(b: int, total: int, n_print: int, n_plot: int) -> int:
    """First step index > b at which any host event fires (verbatim from
    the JAX engine: the one chunk-boundary formula)."""
    nxt = ((b // n_print) + 1) * n_print
    nxt = min(nxt, ((b // n_plot) + 1) * n_plot)
    if b < total - 1:
        nxt = min(nxt, total - 1)
    return min(nxt, total)


def check_params(model, state: TrainState, source: str) -> None:
    """A restored state must carry exactly the model's parameters: the
    functional forward would otherwise fall back to the module's own
    initial values for a missing one."""
    want = {k: tuple(p.shape) for k, p in model.named_parameters()}
    for tree in (state.params, state.m, state.v):
        got = {k: tuple(t.shape) for k, t in tree.items()}
        if got != want:
            raise ValueError(f"{source}: parameters {got} do not match the "
                             f"model's {want}")


def check_moments(state: TrainState, adam_dtype: str, source: str) -> None:
    """A resumed state's Adam moments must have the dtypes ``--adam_dtype``
    gives them (``moment_dtype``): the flag must match across ``--resume``."""
    for tree in (state.m, state.v):
        for k, t in tree.items():
            if t.dtype != moment_dtype(t.shape, adam_dtype):
                raise ValueError(
                    f"{source}: the checkpoint's Adam moments are --adam_dtype "
                    f"{state.adam_dtype} ({k} is {t.dtype}), this run's --adam_dtype is "
                    f"{adam_dtype}; --adam_dtype must match across --resume")


def check_finite_losses(losses: np.ndarray, step0: int, what: str = "") -> None:
    """``--debug_nans``: raise ``FloatingPointError`` naming the step of the
    first non-finite value of a chunk's host losses (steps from ``step0``)."""
    bad = np.flatnonzero(~np.isfinite(np.asarray(losses).reshape(-1)))
    if bad.size:
        raise FloatingPointError(f"--debug_nans: non-finite training loss{what} at step "
                                 f"{step0 + int(bad[0])}")


def check_finite_state(state: TrainState, step: int, what: str = "") -> None:
    """``--debug_nans``: raise ``FloatingPointError`` naming the step and the
    leaves when a parameter or Adam moment holds a non-finite value."""
    bad = [f"{tree}[{k}]" for tree, d in (("params", state.params), ("m", state.m),
                                           ("v", state.v))
           for k, t in d.items() if not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(f"--debug_nans: non-finite state{what} at step {step}: "
                                 f"{', '.join(bad)}")


@contextlib.contextmanager
def profile_chunk(dirname: str, device: torch.device):
    """``--profile``: ``torch.profiler`` around one chunk, CPU and (on a
    card) CUDA activities, waited for before the trace stops; the Chrome
    trace goes to ``<dirname>/profile/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out = os.path.join(dirname, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] one chunk traced to {path}", file=sys.stderr, flush=True)


class Trainer:
    """Owns model, state and device, and drives the chunked training loop."""

    def __init__(self, cfg: RunConfig, dataset: DistributionDataset,
                 output_dir: str):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.dataset = dataset
        self.dirname = output_dir
        self._corpus_saved = False  # the dataset's copy is written at the first save
        self.n_plot = cfg.n_plot or N_PLOT
        self.n_print = cfg.n_print or N_PRINT
        self.eval_batch_size = EVAL_BATCH_SIZE
        self.latent_dim = cfg.latent_dimension

        dots = bf16_dots(cfg.precision, self.device)  # --precision on this device
        dataset.bf16_dots = dots  # its manifold dots take the model's mode
        arch = cfg.arch
        if arch == "auto":
            arch = "conv" if dataset.is_epochs else "mlp"
        if arch == "conv":
            if len(dataset.shape) != 3:
                raise ValueError(
                    "--arch conv requires an image dataset (H, W, C); "
                    f"--dataset {cfg.dataset} has shape {tuple(dataset.shape)}")
            self.model = build_conv_vae(
                image_hwc=tuple(dataset.shape), latent_dim=cfg.latent_dimension,
                channels_spec=cfg.conv_channels, epsilon=cfg.epsilon,
                tunable_decoder_var=cfg.tunable_decoder_var, bf16_dots=dots)
        else:
            self.model = build_vae(
                data_dim=dataset.dimension, latent_dim=cfg.latent_dimension,
                encoder_layer_sizes=cfg.encoder_layer_sizes,
                decoder_layer_sizes=cfg.layer_sizes, epsilon=cfg.epsilon,
                tunable_decoder_var=cfg.tunable_decoder_var,
                dataset_name=cfg.dataset, bf16_dots=dots)
        self.model.init_parameters(cfg.model_seed)
        self.model.to(self.device)

        # Run seeds (64-bit Philox keys): training batches and eval batches
        # from the dataset seed (the JAX engine's fold_in(data_root, 1|2)),
        # prior noise from the model seed.
        self.eval_data_seed = rng.derive_seed(cfg.dataset_seed, rng.SEED_EVAL_DATA)
        self.eval_z_seed = rng.derive_seed(cfg.model_seed, rng.SEED_EVAL_Z)
        self.plot_z_seed = rng.derive_seed(cfg.model_seed, rng.SEED_PLOT_Z)
        params = dict(self.model.named_parameters())
        if cfg.warm_start:
            params = apply_warm_start(
                params, cfg.dataset, dataset, cfg.latent_dimension, cfg.latent_off_dimension,
                rng.derive_seed(cfg.model_seed, rng.SEED_WARM_START))
        self.state = TrainState.create(
            params,
            data_seed=rng.derive_seed(cfg.dataset_seed, rng.SEED_TRAIN_DATA),
            model_seed=rng.derive_seed(cfg.model_seed, rng.SEED_TRAIN_Z),
            adam_dtype=cfg.adam_dtype)

        # an epoch dataset's chunk is EpochChunk(state, epoch, n_batches);
        # under --mesh the chunk is sharded over the ranks (parallel/api.py)
        self.fns = make_parallel_chunk(self.model, dataset, cfg) if cfg.mesh else None
        chunk = self.fns.train_chunk if self.fns else make_train_chunk(self.model, dataset, cfg)
        if dataset.is_epochs:
            self.epoch_chunk = chunk
        else:
            self.train_chunk = chunk
        self.epoch_num = 0

        self.recorder = StatsRecorder()
        self.current_epsilon = cfg.epsilon
        self.batchnum = 0
        self._eval_counter = 0
        self._resumed_with_aux = False
        self._skip_events_at = -1
        self._plot_skip_noted = False
        # (params, grads) host copies an eval under --track_correlation
        self.params_and_gradients: list = []

        if cfg.resume:
            get_artifact_writer().drain()  # a save still queued for that directory
            check_shared_fs(checkpoint_exists(cfg.resume), cfg.resume)
            if not checkpoint_exists(cfg.resume):
                raise FileNotFoundError(f"--resume {cfg.resume}: no checkpoint there")
            # the newest save whose state, aux and meta are all on disk: a
            # kill in the middle of a save (a supervised row's deadline)
            # leaves pieces of two
            self.state, aux, meta = restore_run(cfg.resume, self.device)
            check_params(self.model, self.state, f"--resume {cfg.resume}")
            check_moments(self.state, cfg.adam_dtype, f"--resume {cfg.resume}")
            self.batchnum = int(self.state.step)
            if aux is not None and aux.get("step", self.batchnum) != self.batchnum:
                print(f"[resume] checkpoint aux is from step {aux['step']}, state "
                      f"is at {self.batchnum}; resuming without host-side history",
                      flush=True)
                aux = None
            if aux is not None:
                self.recorder = StatsRecorder.from_state(aux["recorder"])
                self._eval_counter = int(aux["eval_counter"])
                self.params_and_gradients = list(aux.get("params_and_gradients", []))
                self.epoch_num = int(aux.get("epoch_num", 0))
                self._resumed_with_aux = True
                if aux.get("events_fired_at_step", False):
                    self._skip_events_at = self.batchnum
            meta = meta or {}
            if "current_epsilon" in meta:
                self.current_epsilon = meta["current_epsilon"]
        elif cfg.state_dict:
            check_shared_fs(os.path.exists(cfg.state_dict), cfg.state_dict,
                            what="state dict")
            if not os.path.exists(cfg.state_dict):
                raise FileNotFoundError(f"--state_dict {cfg.state_dict} does not exist")
            loaded = load_model_pkl(cfg.state_dict)
            check_params(self.model, loaded, f"--state_dict {cfg.state_dict}")
            # copy_ casts into this run's moment dtypes: a bf16 moment takes
            # the loaded float32 value rounded once, to nearest even
            for dst, src in ((self.state.params, loaded.params),
                             (self.state.m, loaded.m), (self.state.v, loaded.v)):
                for k in dst:
                    dst[k].copy_(src[k])
            self.state.count = loaded.count
        if self.fns is not None:  # this rank's shard under tp; dp keeps it whole
            self.state = self.fns.place_state(self.state)

    # ------------------------------------------------------------------
    def _next_eval_counter(self) -> int:
        self._eval_counter += 1
        return self._eval_counter

    def full_state(self) -> TrainState:
        """The whole state: under tensor parallelism every rank's shards
        all-gathered (a collective: every rank calls it at the same
        events), else the state itself."""
        return self.fns.full_state(self.state) if self.fns else self.state

    def _epsilon_tensor(self) -> torch.Tensor:
        eps = np.asarray(self.current_epsilon, np.float32).reshape(-1)[0]
        return torch.tensor(eps, dtype=torch.float32, device=self.device)

    def compute_stats(self) -> dict:
        """Eval pass: ELBO components on a real batch + the analytic score
        of a generated batch (on the host for a ``score_on_host`` dataset);
        records the eval loss and variances. Under ``--debug_nans`` the
        state is checked first; under ``--track_correlation`` host copies of
        the parameters and of the eval batch's gradients are kept."""
        if self.cfg.debug_nans:
            check_finite_state(self.state, self.batchnum)
        counter = self._next_eval_counter()
        params = self.full_state().params
        out, logvar_e, epsilon = eval_to_host(self.dataset, eval_step(
            self.model, self.dataset, params, self.eval_data_seed,
            self.eval_z_seed, counter, self._epsilon_tensor(), n=self.eval_batch_size))
        self.recorder.append_eval(out["VAE Loss"], logvar_e, epsilon)
        self.current_epsilon = epsilon
        if self.cfg.track_correlation:
            grads = eval_gradients(self.model, self.dataset, params,
                                   self.eval_data_seed, self.eval_z_seed, counter,
                                   n=self.eval_batch_size)
            host = lambda d: {k: t.detach().cpu().numpy().copy() for k, t in d.items()}  # noqa: E731
            self.params_and_gradients.append((host(params), host(grads)))
        return out

    def write_stats(self, stats: dict, console_only: Optional[dict] = None) -> None:
        """The stat line: "Batch | step" or, for an epoch dataset, "Epoch |
        epoch". Every process records it; the primary prints it."""
        is_epochs = self.dataset.is_epochs
        num = self.epoch_num if is_epochs else self.batchnum
        message = self.recorder.write_stats(num, stats, is_epochs=is_epochs,
                                            console_only=console_only)
        if is_primary():
            print(message, flush=True)

    def plot_epoch(self) -> None:
        """The figure of a generated batch, ``output_<step>.png`` (for an
        epoch dataset ``output_<epoch>.png``); the prior draw is keyed by
        the step either way. The primary process draws and writes it."""
        params = self.full_state().params
        if not is_primary():
            return
        z1, z2 = sample_z(self.plot_z_seed, self.batchnum, self.eval_batch_size,
                          self.latent_dim, self.dataset.dimension, self.device)
        batch = generate(self.model, params, z1, z2, self._epsilon_tensor())
        tag = self.epoch_num if self.dataset.is_epochs else self.batchnum
        fn = os.path.join(self.dirname, f"output_{tag}.png")
        if not self.dataset.plot_batch(batch, fn=fn) and not self._plot_skip_noted:
            print("[plot] matplotlib is not installed; figures are skipped",
                  flush=True)
            self._plot_skip_noted = True

    def sample_latent(self, seed: int, n: int) -> torch.Tensor:
        """Prior draw on the trainer's device, from the Philox streams keyed
        ``seed``. Gaussian: (n, latent_dim + data_dim) = z1 ⊕ z2 at counter
        0. Logistic: (n, latent_dim) = log(u) − log(1 − u) of the uniforms
        of stream Z1, at counter 0, then 1, 2, … until every value is
        finite (a uniform of exactly 1 gives +inf)."""
        dist = self.cfg.latent_distribution
        if dist == "gaussian":
            z1, z2 = sample_z(seed, 0, n, self.latent_dim, self.dataset.dimension,
                              self.device)
            return torch.cat([z1, z2], dim=1)
        if dist == "logistic":
            attempt = 0
            while True:
                w = rng.words(seed, attempt, n, rng.STREAM_Z1, (self.latent_dim + 3) // 4,
                              device=self.device)
                u = rng.uniforms(w).reshape(n, -1)[:, :self.latent_dim]
                sample = torch.log(u) - torch.log(1.0 - u)
                if bool(torch.isfinite(sample).all()):
                    return sample
                attempt += 1
        raise NotImplementedError(f"distribution {dist} is not implemented")

    def latent_likelihood(self, latent_batch: torch.Tensor) -> torch.Tensor:
        """Mean over the batch of the summed prior log-density of each
        latent (``jax.scipy.stats`` norm or logistic ``logpdf``)."""
        x = torch.as_tensor(latent_batch, dtype=torch.float32)
        dist = self.cfg.latent_distribution
        if dist == "gaussian":
            logpdf = -0.5 * x * x - 0.5 * math.log(2.0 * math.pi)
        elif dist == "logistic":
            logpdf = -2.0 * torch.logaddexp(x / 2.0, -x / 2.0)
        else:
            raise NotImplementedError(f"distribution {dist} is not implemented")
        return torch.mean(torch.sum(logpdf, dim=1), dim=0)

    def sample_batch(self, seed: int, n: int, latents: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ancestral sampling with the current decoder log-variance:
        (samples, latents), the latents drawn by ``sample_latent`` unless
        given (z1 ⊕ z2, (n, latent_dim + data_dim))."""
        z = (self.sample_latent(seed, n) if latents is None
             else torch.as_tensor(latents, dtype=torch.float32, device=self.device))
        z1, z2 = z[:, :self.latent_dim], z[:, self.latent_dim:]
        return generate(self.model, self.full_state().params, z1, z2,
                        self._epsilon_tensor()), z

    # ------------------------------------------------------------------
    def train(self) -> None:
        """``train_epochs`` for an epoch dataset, else ``train_distribution``,
        then the writer drained: on return every in-loop artifact is on
        disk. On a crash the queued writes are flushed (the newest
        checkpoint a rerun resumes from) without masking the error."""
        if self.fns is not None and not self.fns.active:
            return  # a rank an uneven mesh leaves out trains nothing
        writer = get_artifact_writer()
        try:
            if self.dataset.is_epochs:
                self.train_epochs()
            else:
                self.train_distribution()
        except BaseException:
            writer.drain_quietly()
            raise
        writer.drain()

    def train_epochs(self) -> None:
        """Epoch mode (the JAX engine's ``train_epochs``): the stats before
        training (unless resumed with the host-side history), then for every
        epoch one ``EpochChunk``, the stats, "Completed Epoch k", the
        "Epoch"-labelled stat line, the figure and a save. A resumed state
        at step S has completed S // n_batches epochs and continues from
        there; each epoch's permutation is keyed by its number, so none is
        replayed."""
        n_batches = self.dataset.n // self.cfg.batch_size  # > 0: EpochBatches checks
        start_epoch = self.state.step // n_batches
        self.batchnum = self.state.step
        if not self._resumed_with_aux:
            self.write_stats(self.compute_stats())
        epochs = range(start_epoch, self.cfg.num_epochs)
        if self.cfg.tqdm and is_primary():
            try:  # as the JAX engine: without tqdm, only the bar is lost
                from tqdm import trange

                epochs = trange(start_epoch, self.cfg.num_epochs)
            except Exception:
                pass
        for self.epoch_num in epochs:
            self.state, losses = self.epoch_chunk(self.state, self.epoch_num, n_batches)
            losses = losses.cpu().numpy()
            if self.cfg.debug_nans:
                check_finite_losses(losses, self.batchnum)
            self.recorder.append_train_losses(losses)
            self.batchnum += n_batches
            stats = self.compute_stats()
            if is_primary():
                print(f"Completed Epoch {self.epoch_num}", flush=True)
            self.write_stats(stats)
            self.plot_epoch()
            self.save()

    def train_distribution(self) -> None:
        if not self._resumed_with_aux:
            eval_batch = self.dataset.sample(self.eval_data_seed,
                                             self._next_eval_counter(),
                                             self.eval_batch_size)
            score = banner_scores(self.dataset, eval_batch)
            if is_primary():
                print(f"Score for real data: {score}", flush=True)

        total = self.cfg.num_batches
        progress = None
        if self.cfg.tqdm and is_primary():
            try:  # as the JAX engine: without tqdm, only the bar is lost
                from tqdm import tqdm

                progress = tqdm(total=total, initial=self.batchnum)
            except Exception:
                progress = None
        profiled = False
        b = self.batchnum
        last_rate_steps, last_rate_time = b, time.perf_counter()
        while b < total:
            self.batchnum = b
            if b % self.n_print == 0 and b != self._skip_events_at:
                stats = self.compute_stats()
                console_only = None
                now = time.perf_counter()
                if b > last_rate_steps and now > last_rate_time:
                    console_only = {"steps/sec": (b - last_rate_steps) / (now - last_rate_time)}
                last_rate_steps, last_rate_time = b, now
                self.write_stats(stats, console_only=console_only)
            if (b % self.n_plot == 0 or b == total - 1) and b != self._skip_events_at:
                self.plot_epoch()
                self.save()
            n = next_event(b, total, self.n_print, self.n_plot) - b
            trace = self.cfg.profile and not profiled and n > 1
            with profile_chunk(self.dirname, self.device) if trace else contextlib.nullcontext():
                self.state, losses = self.train_chunk(self.state, n)
                losses = losses.cpu().numpy()
            profiled = profiled or trace
            if self.cfg.debug_nans:
                check_finite_losses(losses, b)
            self.recorder.append_train_losses(losses)
            every = self.cfg.checkpoint_every
            if every and (b + n) // every > b // every:
                # a between-chunk save: this step's events have not fired
                self._save_checkpoint(events_fired_at_step=False)
            b += n
            if progress is not None:
                progress.update(n)
        self.batchnum = max(total - 1, 0)
        if progress is not None:
            progress.close()

    # ------------------------------------------------------------------
    def _snapshot_aux(self, events_fired_at_step: bool) -> dict:
        """Host state a bit-exact resume needs beyond the TrainState: the
        stat history and the eval counter, and whether this step's
        print/plot events already ran."""
        return {
            "recorder": self.recorder.to_state(),
            "eval_counter": self._eval_counter,
            "epoch_num": self.epoch_num,
            "params_and_gradients": list(self.params_and_gradients),
            "events_fired_at_step": events_fired_at_step,
        }

    def _snapshot(self, events_fired_at_step: bool) -> Tuple[TrainState, dict, dict]:
        """Host copies, taken now, of what a save writes: the whole state
        (the chunks update the device tensors in place; under tp every
        rank takes part in the gather), the checkpoint's meta and its aux."""
        eps = float(np.asarray(self.current_epsilon).reshape(-1)[0])
        # the flag in the meta too: it tells apart two saves of one step
        # (restore_run)
        return (self.full_state().host_copy(),
                {"current_epsilon": eps, "events_fired_at_step": events_fired_at_step},
                self._snapshot_aux(events_fired_at_step))

    def _save_checkpoint(self, events_fired_at_step: bool) -> None:
        state, meta, aux = self._snapshot(events_fired_at_step)
        if is_primary():  # the primary process writes every artifact
            get_artifact_writer().submit(partial(self._checkpoint_writer(), self.dirname,
                                                 state, extra_meta=meta, aux=aux))

    def _checkpoint_writer(self):
        """The save of ``--ckpt_backend``: ``orbax`` writes the DCP
        directory, ``msgpack`` (the default) the torch.save trio."""
        return save_checkpoint_dcp if self.cfg.ckpt_backend == "orbax" else save_checkpoint

    def model_save_data(self, final: bool = False) -> None:
        """At the final save under ``--track_correlation``: the correlation
        ratio of every recorded eval against the final parameters, whole
        tree and per parameter (``Correlation Ratio/<flax path>``)."""
        if not (final and self.params_and_gradients):
            return
        final_params = {k: t.detach().cpu() for k, t in self.full_state().params.items()}
        self.recorder.correlation_ratios = [
            float(correlation_ratio(final_params, p, g)) for p, g in self.params_and_gradients]
        per_param: dict = {}
        for p, g in self.params_and_gradients:
            for path, r in correlation_ratio_per_param(final_params, p, g).items():
                per_param.setdefault(path, []).append(float(r))
        self.recorder.correlation_ratios_per_param = per_param

    def save(self, final: bool = False) -> None:
        """losses.npz, model.pkl, the checkpoint and the dataset's copy
        (``dataset.pk``: an image corpus writes ``dataset.pk.npz``), from
        host copies taken now and written by the background writer;
        ``final=True`` waits for the writes. The corpus never changes, so
        its file is written at a run's first save only, with the bytes every
        later save would write. In-loop saves run after this step's events
        (batchnum == state.step); the final save runs after the loop, where
        no events at state.step have fired."""
        self.model_save_data(final=final)
        state, meta, aux = self._snapshot(self.batchnum == int(self.state.step))
        if not is_primary():
            return
        dirname, write_checkpoint = self.dirname, self._checkpoint_writer()
        corpus = None if self._corpus_saved else self.dataset.host_copy()
        self._corpus_saved = True

        def write_run():
            StatsRecorder.from_state(aux["recorder"]).save_npz(dirname, final=final)
            save_model_pkl(os.path.join(dirname, "model.pkl"), state)
            write_checkpoint(dirname, state, extra_meta=meta, aux=aux)
            if corpus is not None:
                corpus.save(os.path.join(dirname, "dataset.pk"))

        writer = get_artifact_writer()
        writer.submit(write_run)
        if final:
            writer.drain()
