"""The training engine: chunked training with host-side cadences.

Port of ``vae_training_tpu/train/loop.py:56-689`` (distribution mode).
Behavioural contract kept:

  - a stat line every ``n_print`` steps, plot + save every ``n_plot`` steps
    and at the last step, eval batch 1000;
  - events fire BEFORE that step's update (the batch-0 eval sees the freshly
    initialised model);
  - the "Score for real data" line at train start;
  - per-step training losses recorded (the npz "VAE Loss" trace);
  - between events one ``train_chunk`` covers every intervening step (the
    fused kernel or the torch path, ``kernels/dispatch.py``).

Random streams: the JAX engine splits a host key chain for eval and plot
draws; here every draw is counter-keyed (``ops/rng.py``): eval batches by
the eval counter, plot draws by the step. A resumed run therefore draws
exactly what an uninterrupted one draws, whatever events the interrupted
run fired. Epoch-mode (image) training is not ported yet: the registry
rejects the image dataset.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import RunConfig
from ..data.base import DistributionDataset
from ..evals.stats import StatsRecorder
from ..kernels.dispatch import make_train_chunk
from ..models.networks import build_vae
from ..ops import rng
from ..runio.checkpoint import (
    checkpoint_exists,
    read_checkpoint_meta,
    restore_checkpoint,
    restore_checkpoint_aux,
    save_checkpoint,
)
from ..runio.export import load_model_pkl, save_model_pkl
from .state import TrainState
from .step import eval_step, generate, sample_z

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


class Trainer:
    """Owns model, state and device, and drives the chunked training loop."""

    def __init__(self, cfg: RunConfig, dataset: DistributionDataset,
                 output_dir: str):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.dataset = dataset
        self.dirname = output_dir
        self.n_plot = cfg.n_plot or N_PLOT
        self.n_print = cfg.n_print or N_PRINT
        self.eval_batch_size = EVAL_BATCH_SIZE
        self.latent_dim = cfg.latent_dimension

        self.model = build_vae(
            data_dim=dataset.dimension, latent_dim=cfg.latent_dimension,
            encoder_layer_sizes=cfg.encoder_layer_sizes,
            decoder_layer_sizes=cfg.layer_sizes, epsilon=cfg.epsilon,
            tunable_decoder_var=cfg.tunable_decoder_var,
            dataset_name=cfg.dataset)
        self.model.init_parameters(cfg.model_seed)
        self.model.to(self.device)

        # Run seeds (64-bit Philox keys): training batches and eval batches
        # from the dataset seed (the JAX engine's fold_in(data_root, 1|2)),
        # prior noise from the model seed.
        self.eval_data_seed = rng.derive_seed(cfg.dataset_seed, rng.SEED_EVAL_DATA)
        self.eval_z_seed = rng.derive_seed(cfg.model_seed, rng.SEED_EVAL_Z)
        self.plot_z_seed = rng.derive_seed(cfg.model_seed, rng.SEED_PLOT_Z)
        self.state = TrainState.create(
            dict(self.model.named_parameters()),
            data_seed=rng.derive_seed(cfg.dataset_seed, rng.SEED_TRAIN_DATA),
            model_seed=rng.derive_seed(cfg.model_seed, rng.SEED_TRAIN_Z))

        self.train_chunk = make_train_chunk(self.model, dataset, cfg)

        self.recorder = StatsRecorder()
        self.current_epsilon = cfg.epsilon
        self.batchnum = 0
        self._eval_counter = 0
        self._resumed_with_aux = False
        self._skip_events_at = -1
        self._plot_skip_noted = False

        if cfg.resume:
            if not checkpoint_exists(cfg.resume):
                raise FileNotFoundError(f"--resume {cfg.resume}: no checkpoint there")
            self.state = restore_checkpoint(cfg.resume, self.device)
            self._check_params(self.state, f"--resume {cfg.resume}")
            self.batchnum = int(self.state.step)
            aux = restore_checkpoint_aux(cfg.resume)
            if aux is not None and aux.get("step", self.batchnum) != self.batchnum:
                print(f"[resume] checkpoint aux is from step {aux['step']}, state "
                      f"is at {self.batchnum}; resuming without host-side history",
                      flush=True)
                aux = None
            if aux is not None:
                self.recorder = StatsRecorder.from_state(aux["recorder"])
                self._eval_counter = int(aux["eval_counter"])
                self._resumed_with_aux = True
                if aux.get("events_fired_at_step", False):
                    self._skip_events_at = self.batchnum
            meta = read_checkpoint_meta(cfg.resume) or {}
            if "current_epsilon" in meta:
                self.current_epsilon = meta["current_epsilon"]
        elif cfg.state_dict:
            if not os.path.exists(cfg.state_dict):
                raise FileNotFoundError(f"--state_dict {cfg.state_dict} does not exist")
            loaded = load_model_pkl(cfg.state_dict)
            self._check_params(loaded, f"--state_dict {cfg.state_dict}")
            for dst, src in ((self.state.params, loaded.params),
                             (self.state.m, loaded.m), (self.state.v, loaded.v)):
                for k in dst:
                    dst[k].copy_(src[k])
            self.state.count = loaded.count

    def _check_params(self, state: TrainState, source: str) -> None:
        """A restored state must carry exactly the model's parameters: the
        functional forward would otherwise fall back to the module's own
        initial values for a missing one."""
        want = {k: tuple(p.shape) for k, p in self.model.named_parameters()}
        for tree in (state.params, state.m, state.v):
            got = {k: tuple(t.shape) for k, t in tree.items()}
            if got != want:
                raise ValueError(f"{source}: parameters {got} do not match the "
                                 f"model's {want}")

    # ------------------------------------------------------------------
    def _next_eval_counter(self) -> int:
        self._eval_counter += 1
        return self._eval_counter

    def _epsilon_tensor(self) -> torch.Tensor:
        eps = np.asarray(self.current_epsilon, np.float32).reshape(-1)[0]
        return torch.tensor(eps, dtype=torch.float32, device=self.device)

    def compute_stats(self) -> dict:
        """Eval pass: ELBO components on a real batch + the analytic score
        of a generated batch; records the eval loss and variances."""
        counter = self._next_eval_counter()
        out = eval_step(self.model, self.dataset, self.state.params,
                        self.eval_data_seed, self.eval_z_seed, counter,
                        self._epsilon_tensor(), n=self.eval_batch_size)
        # copies: logvar_e is the live epsilon_p, which later steps update
        out = {k: v.detach().cpu().numpy().copy() for k, v in out.items()}
        logvar_e = out.pop("_logvar_e")
        epsilon = out.pop("_epsilon")
        self.recorder.append_eval(out["VAE Loss"], logvar_e, epsilon)
        self.current_epsilon = epsilon
        return out

    def write_stats(self, stats: dict, console_only: Optional[dict] = None) -> None:
        print(self.recorder.write_stats(self.batchnum, stats,
                                        console_only=console_only), flush=True)

    def plot_epoch(self) -> None:
        z1, z2 = sample_z(self.plot_z_seed, self.batchnum, self.eval_batch_size,
                          self.latent_dim, self.dataset.dimension, self.device)
        batch = generate(self.model, self.state.params, z1, z2,
                         self._epsilon_tensor())
        fn = os.path.join(self.dirname, f"output_{self.batchnum}.png")
        if not self.dataset.plot_batch(batch, fn=fn) and not self._plot_skip_noted:
            print("[plot] matplotlib is not installed; figures are skipped",
                  flush=True)
            self._plot_skip_noted = True

    # ------------------------------------------------------------------
    def train_distribution(self) -> None:
        if not self._resumed_with_aux:
            eval_batch = self.dataset.sample(self.eval_data_seed,
                                             self._next_eval_counter(),
                                             self.eval_batch_size)
            score = {k: float(v) for k, v in self.dataset.score(eval_batch).items()}
            print(f"Score for real data: {score}", flush=True)

        total = self.cfg.num_batches
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
            self.state, losses = self.train_chunk(self.state, n)
            self.recorder.append_train_losses(losses.cpu().numpy())
            every = self.cfg.checkpoint_every
            if every and (b + n) // every > b // every:
                # a between-chunk save: this step's events have not fired
                self._save_checkpoint(events_fired_at_step=False)
            b += n
        self.batchnum = max(total - 1, 0)

    # ------------------------------------------------------------------
    def _snapshot_aux(self, events_fired_at_step: bool) -> dict:
        """Host state a bit-exact resume needs beyond the TrainState: the
        stat history and the eval counter, and whether this step's
        print/plot events already ran."""
        return {
            "recorder": self.recorder.to_state(),
            "eval_counter": self._eval_counter,
            "epoch_num": 0,
            "params_and_gradients": [],
            "events_fired_at_step": events_fired_at_step,
        }

    def _save_checkpoint(self, events_fired_at_step: bool) -> None:
        eps = float(np.asarray(self.current_epsilon).reshape(-1)[0])
        save_checkpoint(self.dirname, self.state,
                        extra_meta={"current_epsilon": eps},
                        aux=self._snapshot_aux(events_fired_at_step))

    def save(self, final: bool = False) -> None:
        """losses.npz, model.pkl and the checkpoint. In-loop saves run after
        this step's events (batchnum == state.step); the final save runs
        after the loop, where no events at state.step have fired."""
        self.recorder.save_npz(self.dirname, final=final)
        save_model_pkl(os.path.join(self.dirname, "model.pkl"), self.state)
        self._save_checkpoint(
            events_fired_at_step=(self.batchnum == int(self.state.step)))
