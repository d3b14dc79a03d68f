"""Seed grids: one configuration trained across many dataset seeds, every
row's chunk in one kernel launch.

Port of ``vae_training_tpu/train/grid.py:164-1109``. The reference's sweep
scripts run each (seed, row) as its own process; ``--seed_grid 2,3,4``
trains the seeds together: one dataset and one ``TrainState`` a row, one
model for the group, and between host events one chunk over every row
(``kernels/dispatch.py:make_grid_chunk``: K6a, the grid mode of the linear
kernel, one CTA per row; or K6b, the grid mode of the MLP kernel, one
thread-block cluster per row in one launch).

Seeds follow the solo Trainer exactly (``train/loop.py``): a row's data
seed is ``derive_seed(dataset_seed, SEED_TRAIN_DATA)`` and its eval-data
seed ``derive_seed(dataset_seed, SEED_EVAL_DATA)``; the model seeds (init,
z, eval z, plot z) are shared, as every solo run of a sweep uses the same
``--model_seed``. Row i of a grid is therefore the solo run with
``-ds seed_i``: the same losses.npz and model.pkl, bitwise, because a K6a or
K6b row runs the solo kernel's body and the plain path is per row.

Each row writes ``<name>_seed<N>/`` (losses.npz, model.pkl, checkpoint with
the host-side aux) from host copies taken at the event, on the background
writer (``runio/background.py``); ``train`` returns with every write on
disk, and a restore waits for queued writes first. ``--resume`` resumes
every row from its own directory and rolls a row that saved one event
ahead back to the grid's common step through its ``.prev`` checkpoint.

``-ws`` gives each row its own analytic warm start over that row's
manifold (its own ``pinv(A)``) from the shared warm-start draws, as the
solo run with that row's seed makes it, so a warm-started row equals its
warm-started solo run bitwise. ``--track_correlation`` and a non-gaussian
latent are refused, with the JAX package's messages, and so are an epoch
dataset (an image corpus) and ``--arch conv``.

``--mesh dp=N`` shards the seed rows over the ranks of the run (JAX
``grid.py:11-24, 210-260``): rank r owns the contiguous block of rows
``[r·k, (r+1)·k)``, k = seeds / N, as ``P("dp")`` places them, and trains
it with one launch a chunk (K6a or K6b, or the torch path) with no
collective. The JAX package's refusals hold: the seed count must divide by
dp, tp does not apply, dp_dcn makes no sense, and over several processes
(``--multihost``) a mesh is required and must span every process. Each
rank evaluates, prints (with a ``[pK] `` prefix when there are several
processes), plots and writes only its own rows; the primary makes every
row's directory and a barrier releases the other ranks' writes; a restore
checks each row's checkpoint is seen by every process (``check_shared_fs``).
Rows are independent, so a sharded row equals the same row of the
unsharded grid bitwise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np
import torch

from ..config import RunConfig, bf16_dots
from ..data.registry import get_dataset
from ..evals.stats import StatsRecorder
from ..kernels.dispatch import make_grid_chunk
from ..models.networks import build_vae
from ..models.warm_start import apply_warm_start
from ..ops import rng
from ..runio.background import get_artifact_writer
from ..runio.checkpoint import (
    checkpoint_exists,
    promote_prev_checkpoint,
    read_checkpoint_meta,
    restore_checkpoint,
    restore_checkpoint_aux,
    restore_checkpoint_prev,
    save_checkpoint,
)
from ..runio.export import save_model_pkl
from ..runio.outdir import make_output_dir
from ..utils.process import barrier, check_shared_fs, process_count, process_index
from ..utils.spans import span
from .loop import (
    EVAL_BATCH_SIZE,
    N_PLOT,
    N_PRINT,
    check_finite_losses,
    check_finite_state,
    check_moments,
    check_params,
    next_event,
)
from .state import TrainState
from .step import banner_scores, eval_step, eval_to_host, generate, sample_z


class GridTrainer:
    """Train one configuration across many dataset seeds, one chunk over
    every row between host events. ``build_chunk=False`` leaves the chunk
    to a caller that launches many grids together (``MixedGridSweep``)."""

    def __init__(self, cfg: RunConfig, seeds: Sequence[int], build_chunk: bool = True):
        cfg.validate()
        self.cfg = cfg
        self.seeds = list(seeds)
        if not self.seeds:
            raise ValueError("--seed_grid needs at least one dataset seed")
        if len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"--seed_grid repeats a seed: {self.seeds}")
        if cfg.state_dict:
            raise NotImplementedError(
                "--seed_grid starts fresh or resumes from its own row checkpoints "
                "(--resume); --state_dict applies to solo runs")
        if cfg.track_correlation:
            raise NotImplementedError(
                "--track_correlation is a solo-run diagnostic (per-parameter "
                "ratios against a converged target); run the row without "
                "--seed_grid to record it")
        if cfg.latent_distribution != "gaussian":
            raise NotImplementedError(
                "--seed_grid supports the gaussian latent distribution "
                "(the CLI forces gaussian like the reference, run.py:41)")
        if cfg.ckpt_backend != "msgpack":
            raise NotImplementedError(
                "--seed_grid checkpoints every row through the msgpack (torch.save) "
                "path: its .prev retention is what lets restore roll skew-killed rows "
                "back to the grid's common step (rollback has no orbax/DCP "
                "implementation, and N checkpoint directories per save event would "
                "serialize the background writer); --ckpt_backend orbax is a "
                "solo-run option")
        # rows this rank trains, evaluates and writes; a MixedGridSweep sets
        # them for the groups it shards (build_chunk=False)
        self.rows = list(range(len(self.seeds)))
        self.mesh = grid_mesh(cfg, len(self.seeds)) if cfg.mesh else None
        if build_chunk:
            require_spanning_mesh(self.mesh)
        if self.mesh is not None:  # it spans every rank
            k = len(self.seeds) // self.mesh.shape["dp"]
            r = self.mesh.coords(process_index())["dp"]
            self.rows = list(range(r * k, (r + 1) * k))
        self.prefix = f"[p{process_index()}] " if process_count() > 1 else ""
        self.device = torch.device(cfg.device)
        self.n_print = cfg.n_print or N_PRINT
        self.n_plot = cfg.n_plot or N_PLOT
        self.eval_batch_size = EVAL_BATCH_SIZE
        self.datasets = [get_dataset(cfg.dataset, s, cfg, device=self.device)
                         for s in self.seeds]
        if any(d.is_epochs for d in self.datasets):
            raise NotImplementedError(
                "--seed_grid supports distribution datasets; epoch-mode "
                "image corpora train one run at a time")
        if cfg.arch == "conv":
            raise ValueError("--seed_grid supports the MLP VAE architectures")
        self.data_dim = self.datasets[0].dimension
        self.latent_dim = cfg.latent_dimension
        self.model = build_vae(
            data_dim=self.data_dim, latent_dim=cfg.latent_dimension,
            encoder_layer_sizes=cfg.encoder_layer_sizes,
            decoder_layer_sizes=cfg.layer_sizes, epsilon=cfg.epsilon,
            tunable_decoder_var=cfg.tunable_decoder_var, dataset_name=cfg.dataset,
            bf16_dots=bf16_dots(cfg.precision, self.device))
        self.model.init_parameters(cfg.model_seed)
        self.model.to(self.device)
        params = dict(self.model.named_parameters())
        ws_seed = rng.derive_seed(cfg.model_seed, rng.SEED_WARM_START)
        model_seed = rng.derive_seed(cfg.model_seed, rng.SEED_TRAIN_Z)
        self.states: List[TrainState] = [
            TrainState.create(
                apply_warm_start(params, cfg.dataset, d, cfg.latent_dimension,
                                 cfg.latent_off_dimension, ws_seed) if cfg.warm_start
                else params,
                data_seed=rng.derive_seed(s, rng.SEED_TRAIN_DATA),
                model_seed=model_seed, adam_dtype=cfg.adam_dtype)
            for s, d in zip(self.seeds, self.datasets)]
        self.eval_data_seeds = [rng.derive_seed(s, rng.SEED_EVAL_DATA) for s in self.seeds]
        self.eval_z_seed = rng.derive_seed(cfg.model_seed, rng.SEED_EVAL_Z)
        self.plot_z_seed = rng.derive_seed(cfg.model_seed, rng.SEED_PLOT_Z)
        self.recorders = [StatsRecorder() for _ in self.seeds]
        self.current_epsilon = [cfg.epsilon] * len(self.seeds)
        self.batchnum = 0
        self._eval_counter = 0
        self._skip_events_at = -1  # set by restore() when the events already ran
        self._plot_skip_noted = False
        self.train_chunk = (make_grid_chunk([self.model] * len(self.rows),
                                            [self.datasets[i] for i in self.rows], cfg,
                                            prefix=self.prefix)
                            if build_chunk else None)

    # ------------------------------------------------------------------
    def _epsilon_tensor(self, i: int) -> torch.Tensor:
        eps = np.asarray(self.current_epsilon[i], np.float32).reshape(-1)[0]
        return torch.tensor(eps, dtype=torch.float32, device=self.device)

    def maybe_print_banner(self) -> None:
        """The per-row "Score for real data" line at a fresh start: the
        solo engine's first eval-counter tick."""
        if self._eval_counter != 0:
            return  # resumed with host state: the banner's counter is spent
        self._eval_counter += 1
        for i in self.rows:
            dataset = self.datasets[i]
            batch = dataset.sample(self.eval_data_seeds[i], self._eval_counter,
                                   self.eval_batch_size)
            score = banner_scores(dataset, batch)
            print(f"{self.prefix}[seed {self.seeds[i]}] Score for real data: {score}",
                  flush=True)

    def compute_and_write_stats(self) -> None:
        """One eval per row at the shared counter: the solo Trainer's
        ``compute_stats`` and stat line, with a ``[seed N]`` tag."""
        if self.cfg.debug_nans:
            for i in self.rows:
                check_finite_state(self.states[i], self.batchnum,
                                   f" (row seed {self.seeds[i]})")
        self._eval_counter += 1
        for i in self.rows:
            seed, dataset, state = self.seeds[i], self.datasets[i], self.states[i]
            dev_out = eval_step(self.model, dataset, state.params, self.eval_data_seeds[i],
                                self.eval_z_seed, self._eval_counter, self._epsilon_tensor(i),
                                n=self.eval_batch_size)
            with span("eval.to_host"):
                out, logvar_e, epsilon = eval_to_host(dataset, dev_out)
                rec = self.recorders[i]
                rec.append_eval(out["VAE Loss"], logvar_e, epsilon)
                self.current_epsilon[i] = epsilon
                print(f"{self.prefix}[seed {seed}] {rec.write_stats(self.batchnum, out)}",
                      flush=True)

    def plot_all(self, outdirs: Sequence[str]) -> None:
        """Each row's generated batch at this step (the shared plot draw)."""
        z1, z2 = sample_z(self.plot_z_seed, self.batchnum, self.eval_batch_size,
                          self.latent_dim, self.data_dim, self.device)
        for i in self.rows:
            batch = generate(self.model, self.states[i].params, z1, z2,
                             self._epsilon_tensor(i))
            fn = os.path.join(outdirs[i], f"output_{self.batchnum}.png")
            if not self.datasets[i].plot_batch(batch, fn=fn) and not self._plot_skip_noted:
                print("[plot] matplotlib is not installed; figures are skipped", flush=True)
                self._plot_skip_noted = True

    def save_all(self, outdirs: Sequence[str], final: bool = False) -> None:
        """Every row's losses.npz, model.pkl and checkpoint, one background
        write a row from host copies taken now (the next chunk updates the
        rows' state in place); ``final=True`` waits for the writes. In-loop
        saves run after this step's events (batchnum == step); the final
        save after the loop, where no events at the state's step have
        fired. Each rank writes its own rows (a sharded sweep's group may
        have none here)."""
        if not self.rows:
            return
        events_fired = self.batchnum == int(self.states[self.rows[0]].step)
        writer = get_artifact_writer()
        for i in self.rows:
            with span("save.copy"):
                state, out = self.states[i].host_copy(), outdirs[i]
                meta = {"current_epsilon":
                        float(np.asarray(self.current_epsilon[i]).reshape(-1)[0])}
                aux = {"recorder": self.recorders[i].to_state(),
                       "eval_counter": self._eval_counter, "epoch_num": 0,
                       "params_and_gradients": [], "events_fired_at_step": events_fired}

            def write_row(out=out, state=state, meta=meta, aux=aux):
                StatsRecorder.from_state(aux["recorder"]).save_npz(out, final=final)
                save_model_pkl(os.path.join(out, "model.pkl"), state)
                save_checkpoint(out, state, extra_meta=meta, aux=aux)

            with span("save.submit"):  # blocks while the writer's queue is full
                writer.submit(write_row)
        if final:
            writer.drain()

    def run_chunk(self, n_steps: int) -> None:
        states, losses = self.train_chunk([self.states[i] for i in self.rows], n_steps)
        for i, state in zip(self.rows, states):
            self.states[i] = state
        self.record_losses(losses.cpu().numpy())

    def record_losses(self, losses: np.ndarray) -> None:
        """The chunk losses of this rank's rows, in order (host copies, the
        chunk starting at ``batchnum``), checked under ``--debug_nans``."""
        for i, row in zip(self.rows, losses):
            if self.cfg.debug_nans:
                check_finite_losses(row, self.batchnum, f" (row seed {self.seeds[i]})")
            self.recorders[i].append_train_losses(row)

    # ------------------------------------------------------------------
    def restore(self, outdirs: Sequence[str]) -> None:
        """Resume every row from its own checkpoint. All rows save at the
        same events, so their steps agree, unless a kill landed between two
        rows' saves: then the rows that got one save ahead roll back to
        their retained ``.prev`` checkpoint at the grid's common step, and
        that trio is promoted to current (else the newer meta step would
        make the step guard refuse every later save). Writes still queued
        for these directories land first."""
        get_artifact_writer().drain()
        # per-row visibility: with per-host disks each process sees only its
        # own rows, and one all() would agree on False everywhere
        check_shared_fs([checkpoint_exists(o) for o in outdirs],
                        os.path.dirname(outdirs[0]) or outdirs[0],
                        what="grid row checkpoints")
        for out in outdirs:
            if not checkpoint_exists(out):
                raise FileNotFoundError(f"--resume: no checkpoint in {out}")
        # pass 1: every row's newest checkpoint
        restored = [restore_checkpoint(out, self.device) for out in outdirs]
        steps = [int(s.step) for s in restored]
        # pass 2: roll back to the newest common step
        target = min(steps)
        rolled = [i for i, s in enumerate(steps) if s != target]
        for i in rolled:
            try:
                prev = restore_checkpoint_prev(outdirs[i], self.device)
            except OSError:
                prev = None
            prev_step = None if prev is None else int(prev.step)
            if prev_step != target:
                raise ValueError(
                    f"grid rows checkpointed at different steps {sorted(set(steps))}, and "
                    f"{outdirs[i]} (step {steps[i]}) has no retained previous checkpoint "
                    f"at the common step {target} (found: {prev_step}). A kill between "
                    f"row saves skews rows by at most one save event; resume rows solo "
                    f"with --resume <name>_seed<N>")
            print(f"[resume] {self.prefix}{outdirs[i]}: rolling back from step {steps[i]} "
                  f"to the grid's common step {target} (retained .prev checkpoint)",
                  flush=True)
            restored[i], steps[i] = prev, target
        for out, state in zip(outdirs, restored):
            check_params(self.model, state, f"--resume {out}")
            check_moments(state, self.cfg.adam_dtype, f"--resume {out}")
        # pass 3: meta (current_epsilon) and aux (stat history, eval counter),
        # the .prev versions for rolled-back rows, either version where the
        # other does not carry the row's step
        for i, out in enumerate(outdirs):
            use_prev = i in rolled
            meta = read_checkpoint_meta(out, prev=use_prev)
            if meta is None or meta.get("step") != steps[i]:
                meta = read_checkpoint_meta(out, prev=not use_prev)
            if meta is not None and meta.get("step") == steps[i] \
                    and "current_epsilon" in meta:
                self.current_epsilon[i] = meta["current_epsilon"]
            aux = restore_checkpoint_aux(out, prev=use_prev)
            if aux is None or aux.get("step") != steps[i]:
                aux = restore_checkpoint_aux(out, prev=not use_prev)
            if aux is not None and aux.get("step", steps[i]) != steps[i]:
                print(f"[resume] {out}: aux is from step {aux['step']}, state is at "
                      f"{steps[i]}; resuming this row without host-side history", flush=True)
                aux = None
            if aux is not None:
                self.recorders[i] = StatsRecorder.from_state(aux["recorder"])
                if i == 0:
                    self._eval_counter = int(aux["eval_counter"])
                    if aux.get("events_fired_at_step", False):
                        self._skip_events_at = steps[0]
        # every process finishes reading the checkpoints before any of them
        # promotes a row or saves again; then each promotes its own rows
        barrier()
        for i in rolled:
            if i in self.rows or process_count() == 1:
                promote_prev_checkpoint(outdirs[i])
        self.batchnum = steps[0]
        self.states = restored

    def train(self, outdirs: Sequence[str]) -> None:
        """The grid's loop; returns with every queued write on disk. On a
        crash the queued writes are flushed without masking the error."""
        writer = get_artifact_writer()
        try:
            self.maybe_print_banner()
            total = self.cfg.num_batches
            b = self.batchnum  # 0 fresh; the checkpoint's step after restore()
            while b < total:
                self.batchnum = b
                if b % self.n_print == 0 and b != self._skip_events_at:
                    self.compute_and_write_stats()
                if (b % self.n_plot == 0 or b == total - 1) and b != self._skip_events_at:
                    self.plot_all(outdirs)
                    self.save_all(outdirs)
                n = next_event(b, total, self.n_print, self.n_plot) - b
                self.run_chunk(n)
                b += n
            self.batchnum = max(total - 1, 0)
        except BaseException:
            writer.drain_quietly()
            raise
        writer.drain()


def grid_mesh(cfg: RunConfig, n_rows: int):
    """The dp mesh that ``--seed_grid ... --mesh`` shards its rows over,
    with the JAX package's refusals (``grid.py:210-236``)."""
    from ..parallel.mesh import make_mesh, parse_mesh_spec

    axes = parse_mesh_spec(cfg.mesh)
    if axes.get("tp", 1) > 1:
        raise ValueError(
            "--seed_grid shards SEEDS over the mesh; use a pure dp "
            "spec (e.g. --mesh dp=8), tp does not apply")
    if axes.get("dp_dcn", 1) > 1:
        raise ValueError(
            "--seed_grid with dp_dcn makes no sense: the sharded "
            "grid chunk has ZERO collectives (seeds are "
            "independent), so there is nothing for a cross-slice "
            "axis to reduce — launch one grid per slice instead "
            "(same aggregate throughput, no DCN dependency)")
    mesh = make_mesh(cfg.mesh, allow_uneven=cfg.mesh_allow_uneven)
    dp = mesh.shape["dp"]
    if n_rows % dp != 0:
        raise ValueError(
            f"--seed_grid with --mesh dp={dp} needs the seed count "
            f"to divide evenly; got {n_rows} seeds")
    return mesh


def require_spanning_mesh(mesh) -> None:
    """Over several processes, rows must shard across all of them, so that
    each process owns and writes its own rows (``grid.py:238-258``)."""
    if process_count() == 1:
        return
    if mesh is None:
        raise ValueError(
            "--seed_grid under --multihost requires a dp mesh "
            "(--mesh dp=N): seed rows must shard across processes "
            "so each process owns and writes its own rows")
    if mesh.size != process_count():
        raise ValueError(
            f"--seed_grid --multihost: the mesh must span every "
            f"process (mesh covers processes {list(range(mesh.size))} "
            f"of {process_count()}); size dp to the global "
            f"device count")


def row_dirs(cfg: RunConfig, seeds: Sequence[int], names: Sequence[str],
             resume: bool) -> List[str]:
    """Each row's output directory and args.json (its own dataset seed);
    a resume keeps what the rows hold."""
    return [make_output_dir(name, cfg.overwrite, dataclasses.replace(cfg, dataset_seed=seed),
                            data_dir=cfg.data_dir, reuse_existing=resume)
            for seed, name in zip(seeds, names)]


def run_seed_grid(cfg: RunConfig, seeds: Sequence[int], name_fn=None) -> int:
    """CLI entry (``--seed_grid``): one chunk over every seed between
    events, ``<name>_seed<N>/`` output dirs (``name_fn(seed)`` overrides
    the name: the sweep runner keeps the reference's run names). With
    ``--resume`` (any value) every row resumes from its own directory."""
    if name_fn is None:
        name_fn = lambda seed: f"{cfg.name}_seed{seed}"  # noqa: E731
    trainer = GridTrainer(cfg, seeds)
    outdirs = row_dirs(cfg, seeds, [name_fn(s) for s in seeds], bool(cfg.resume))
    barrier()  # the primary made every row's directory; the others may write now
    if cfg.resume:
        trainer.restore(outdirs)
    trainer.train(outdirs)
    trainer.save_all(outdirs, final=True)
    return 0

