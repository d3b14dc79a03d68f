"""The general traffic generator: builds the program's training object for
a cell from its configuration file and its workload file, drives it
through the first steps that ``correct`` checks, warms it up and runs the
measured window.

Traffic kinds (the workload file's ``kind``):

  - ``chunks``: a ``MixedGridSweep`` over the configuration's rows (or the
    workload's subset), driven by ``run_chunk(chunk_steps)`` back to back:
    one launch of every row a chunk, each chunk ending in its losses' copy
    to the host;
  - ``cadence``: the same sweep, driven by its own loop
    (``MixedGridSweep.train``) at the configuration's eval and save
    cadence, its outputs in a directory under ``TMPDIR``; the window closes
    at the first chunk boundary after its length, and the checkpoints its
    saves wrote are then read back;
  - ``solo``: one ``Trainer`` of one row, driven by ``train_chunk(state,
    chunk_steps)``.

In every kind set-up builds one object, hands it the initial parameters
the benchmark made from the seed, runs the first steps through the same
call the window makes (the first step alone, so that its gradient can be
read from Adam's state, then the rest in one call, so that the launch's
own loop carries the state from step to step as in the window's chunks),
warms up, and hands that same object to the window.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from . import reference

ROOT = Path(__file__).resolve().parent
FIRST_STEPS = 3


def load(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``workloads/<name>.json``."""
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A float32 host copy that later in-place updates do not reach."""
    return t.detach().to("cpu", torch.float32, copy=True)


class WindowClosed(Exception):
    """Raised at the first chunk boundary after the window's length."""


class Spans:
    """Host-clock spans by name, each (start, end, tag); under a trace each
    is also a ``record_function`` range of the same name."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float, object]]] = {}

    @contextlib.contextmanager
    def span(self, name: str, tag=None):
        with torch.profiler.record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append((t0, time.perf_counter(), tag))

    def rounds(self, name: str) -> List[float]:
        """Seconds of each round: the spans of one tag from the first start
        to the last end."""
        by_tag: Dict[object, List[Tuple[float, float]]] = {}
        for t0, t1, tag in self.spans.get(name, []):
            by_tag.setdefault(tag, []).append((t0, t1))
        return [max(e for _, e in v) - min(s for s, _ in v) for v in by_tag.values()]


def cell_rows(config: dict, workload: dict) -> List[Tuple[int, int, int, int]]:
    """(dd, pd, ld, dataset seed) of every row the cell trains, grouped by
    shape in the configuration's order."""
    shapes = workload.get("rows") or config["rows"]
    seeds = workload.get("dataset_seeds") or config["dataset_seeds"]
    return [(dd, pd, ld, s) for dd, pd, ld in shapes for s in seeds]


def cadence(config: dict, workload: dict) -> Tuple[int, int]:
    """(steps between evals, steps between plot+save events): the
    workload's where it sets them, else the configuration's."""
    return (workload.get("n_print", config["n_print"]),
            workload.get("n_plot", config["n_plot"]))


def run_config(config: dict, workload: dict, dd: int, pd: int, ld: int, dataset_seed: int,
               seed: int, device: str, data_dir: str = "."):
    from vae_training_tpu_torch.config import RunConfig

    return RunConfig(
        name=f"{config['name']}_dd{dd}_pd{pd}_ld{ld}", dataset=config["dataset"],
        encoder_layer_sizes=config["encoder_layer_sizes"], layer_sizes=config["layer_sizes"],
        latent_dimension=ld, padding_dim=pd, dataset_dimension=dd,
        dataset_intrinsic_dimension=config["dataset_intrinsic_dimension"],
        dataset_noise=config["dataset_noise"], num_batches=config["num_batches"],
        batch_size=config["batch_size"], epsilon=config["epsilon"],
        tunable_decoder_var=config["tunable_decoder_var"],
        learning_rate=config["learning_rate"], dataset_seed=dataset_seed,
        n_print=cadence(config, workload)[0], n_plot=cadence(config, workload)[1],
        model_seed=seed,
        kernels=workload["kernels"], precision=workload["precision"],
        adam_dtype=workload["adam_dtype"], device=device, tqdm=False, overwrite=True,
        data_dir=data_dir).validate()


def counters() -> Dict[str, int]:
    """The program's launch and call counters."""
    from vae_training_tpu_torch.kernels import linear_vae, mlp_vae
    from vae_training_tpu_torch.train import step

    return {"K1/K2": linear_vae.run_fused_chunk.launches,
            "K6a": linear_vae.run_grid_chunk.launches,
            "K5": mlp_vae.run_mlp_fused_chunk.launches,
            "K6b": mlp_vae.run_grid_chunk.launches,
            "plain K6a": linear_vae.plain_grid_chunk.calls,
            "plain K6b": mlp_vae.plain_grid_chunk.calls,
            "torch path": step.train_chunk.calls,
            "torch graph": step.GraphChunk.calls}


class Cell:
    """One cell's program object. Subclasses set ``states()`` (each row's
    TrainState, in ``cell_rows`` order) and ``call(n)`` (the window's own
    call: ``n`` steps of every row, returning each row's host losses)."""

    def __init__(self, config: dict, workload: dict, seed: int, device: str):
        self.config, self.workload, self.seed = config, workload, seed
        self.device = torch.device(device)
        self.rows = cell_rows(config, workload)
        self.spans = Spans()
        self.launch_steps = 0  # steps a launch, summed over the window's launches
        self.row_steps = 0
        self._closes_at = None

    def ref_rows(self, device=None) -> List[reference.Row]:
        return [reference.Row(self.config, dd, pd, ld, s, self.seed, device or self.device)
                for dd, pd, ld, s in self.rows]

    def hand_init(self, init: List[Dict[str, torch.Tensor]]) -> None:
        for state, params in zip(self.states(), init):
            if set(state.params) != set(params):
                raise ValueError(f"parameter names differ: {sorted(state.params)} "
                                 f"against {sorted(params)}")
            for k, t in params.items():
                state.params[k].copy_(t)

    def first_steps(self, init) -> dict:
        """The first steps through the window's call: the first alone, then
        the others in one call, whose launch draws each next step's noise
        and carries the state from step to step inside it. Each step's
        losses, the first step's gradient as Adam took it, and the
        parameters' change."""
        losses = [[float(x) for x in value] for value in self.call(1)]
        g1 = [{k: _host(t) / (1.0 - reference.ADAM_B1) for k, t in s.m.items()}
              for s in self.states()]
        for row, value in zip(losses, self.call(FIRST_STEPS - 1)):
            row.extend(float(x) for x in value)
        delta = [{k: _host(t) - _host(p[k]) for k, t in s.params.items()}
                 for s, p in zip(self.states(), init)]
        return {"loss": losses, "g1": g1, "delta": delta}

    def saved(self, init) -> Dict[str, int]:
        """The numbers of what the run wrote to disk, once the window has
        closed (none but in the ``cadence`` kind)."""
        return {}

    def warm(self) -> None:
        self.call(self.workload["chunk_steps"])

    def _chunk(self, n: int):
        """The window's unit: one call, counted; closes the window at the
        first boundary past its end."""
        with self.spans.span("chunk"):
            out = self.call(n)
        self.row_steps += n * len(self.rows)
        self.launch_steps += n
        if self._closes_at is not None and time.perf_counter() >= self._closes_at:
            raise WindowClosed
        return out

    def window(self, seconds: float) -> float:
        """Run the window; returns its wall seconds (to the end of the last
        chunk)."""
        t0 = time.perf_counter()
        self._closes_at = t0 + seconds
        self.row_steps = self.launch_steps = 0
        try:
            self._drive()
        except WindowClosed:
            pass
        return self.spans.spans["chunk"][-1][1] - t0

    def _drive(self) -> None:
        """Chunks back to back until the window closes."""
        while True:
            self._chunk(self.workload["chunk_steps"])

    def close(self) -> None:
        pass


class SweepCell(Cell):
    """The ``chunks`` kind: every row in one launch a chunk."""

    def __init__(self, config, workload, seed, device, out_root: str = "."):
        super().__init__(config, workload, seed, device)
        from vae_training_tpu_torch.train.grid import GridTrainer
        from vae_training_tpu_torch.train.mixed_grid import MixedGridSweep

        self.out_root = out_root
        shapes, seeds = [], {}
        for dd, pd, ld, s in self.rows:
            if (dd, pd, ld) not in seeds:
                shapes.append((dd, pd, ld))
            seeds.setdefault((dd, pd, ld), []).append(s)
        self.groups = [GridTrainer(run_config(config, workload, dd, pd, ld, seeds[dd, pd, ld][0],
                                              seed, device, out_root),
                                   seeds[dd, pd, ld], build_chunk=False)
                       for dd, pd, ld in shapes]
        self.sweep = MixedGridSweep(self.groups)

    def states(self):
        return [g.states[i] for g in self.groups for i in range(len(g.seeds))]

    def call(self, n: int):
        # the class's run_chunk: the cadence window replaces the instance's
        type(self.sweep).run_chunk(self.sweep, n)
        return [g.recorders[i].vae_losses[-1] for g in self.groups for i in range(len(g.seeds))]


class CadenceCell(SweepCell):
    """The ``cadence`` kind: the sweep's own loop, with its evals and its
    plot+save events, writing under a directory of ``TMPDIR``.

    What a save wrote is judged after the window: the step-0 checkpoint of
    every row (set aside in set-up, before a later save replaces it)
    against the initial parameters with zero moments, and every in-window
    save still on disk (the newest and the one before) against the state
    the row held when the loop fired it. Each by its step, its Adam count,
    and each leaf's shape, type and sum of bit patterns (an exact integer,
    summed on the device at the event, so that the check keeps no copy of
    the state). ``ckpt_mismatch`` counts the row checkpoints missing or
    differing, and the rows a save event of the loop's schedule never
    reached."""

    def __init__(self, config, workload, seed, device):
        super().__init__(config, workload, seed, device,
                         tempfile.mkdtemp(prefix="bench_sweep_"))
        self.outdirs = None
        self.step0 = os.path.join(self.out_root, "step0")
        self.snapshots: Dict[int, dict] = {}  # save step → {(group, row): what it must hold}
        self.chunk_starts: List[int] = []

    def first_steps(self, init) -> dict:
        # the sweep's own events at step 0, as its loop fires them before
        # the first update: the banner, an eval round, plot+save
        from vae_training_tpu_torch.train.grid import row_dirs

        self.outdirs = [row_dirs(g.cfg, g.seeds, [f"{g.cfg.name}_seed{s}" for s in g.seeds],
                                 False) for g in self.groups]
        for g in self.groups:
            g.batchnum = 0
            g.maybe_print_banner()
        for g in self.groups:
            g.compute_and_write_stats()
        evals = [{k: float(v[-1]) for k, v in g.recorders[i].stats.items()}
                 for g in self.groups for i in range(len(g.seeds))]
        # what the step-0 checkpoints must hold: the initial parameters and
        # zero moments (of the program's moment types)
        rows = [(n, i) for n, g in enumerate(self.groups) for i in g.rows]
        self.snapshots[0] = {
            key: _fingerprint({"params": p0, "step": 0, "count": 0,
                               "m": {k: torch.zeros_like(t) for k, t in state.m.items()},
                               "v": {k: torch.zeros_like(t) for k, t in state.v.items()}})
            for key, p0, state in zip(rows, init, self.states())}
        for g, outs in zip(self.groups, self.outdirs):
            g.plot_all(outs)
            g.save_all(outs)
        records = super().first_steps(init)
        records["eval"] = evals
        return records

    def warm(self) -> None:
        # on to the next event, as the sweep's loop would go; then the
        # step-0 writes finished and each row's checkpoint set aside
        from vae_training_tpu_torch.runio.background import get_artifact_writer
        from vae_training_tpu_torch.train.loop import next_event

        b = self.groups[0].batchnum + FIRST_STEPS
        nxt = next_event(b, self.config["num_batches"], *cadence(self.config, self.workload))
        self.call(nxt - b)
        for g in self.groups:
            g.batchnum = nxt
        get_artifact_writer().drain()
        os.makedirs(self.step0)
        for n, outs in enumerate(self.outdirs):
            for i, out in enumerate(outs):
                if os.path.exists(os.path.join(out, CKPT_FILE)):
                    shutil.copyfile(os.path.join(out, CKPT_FILE),
                                    os.path.join(self.step0, f"{n}_{i}.pt"))

    def _chunk(self, n: int):
        self.chunk_starts.append(self.groups[0].batchnum)
        return super()._chunk(n)

    def _drive(self) -> None:
        # the sweep's own loop, its chunks and events timed
        for n, g in enumerate(self.groups):
            g.compute_and_write_stats = self._spanned("eval", g, g.compute_and_write_stats)
            g.plot_all = self._spanned("save", g, g.plot_all)
            g.save_all = self._snapshotted(n, g, self._spanned("save", g, g.save_all))
        self.sweep.run_chunk = self._chunk
        self.sweep.train(self.outdirs)

    def _spanned(self, name, group, fn):
        def wrapped(*args, **kwargs):
            with self.spans.span(name, tag=group.batchnum):
                return fn(*args, **kwargs)
        return wrapped

    def _snapshotted(self, n, group, fn):
        def wrapped(*args, **kwargs):
            self.snapshots.setdefault(group.batchnum, {}).update(
                ((n, i), _fingerprint(group.states[i])) for i in group.rows)
            return fn(*args, **kwargs)
        return wrapped

    def saved(self, init) -> Dict[str, int]:
        from vae_training_tpu_torch.runio.background import get_artifact_writer

        get_artifact_writer().drain_quietly()
        # the step-0 save, and every plot+save the loop's schedule holds
        # between the window's first chunk and its last, newest first
        n_plot = cadence(self.config, self.workload)[1]
        first = -(-self.chunk_starts[0] // n_plot) * n_plot
        due = list(reversed(range(first, self.chunk_starts[-1] + 1, n_plot)))
        bad = 0
        for age, step in enumerate(due + [0]):
            fired = self.snapshots.get(step, {})
            for n, (g, outs) in enumerate(zip(self.groups, self.outdirs)):
                for i in g.rows:
                    if (n, i) not in fired:
                        bad += 1
                        continue
                    if step == 0:  # set aside in set-up
                        path = os.path.join(self.step0, f"{n}_{i}.pt")
                    elif age < 2:  # the newest on disk, and the one it set aside
                        path = os.path.join(outs[i], CKPT_FILE + ("" if age == 0 else PREV_SUFFIX))
                    else:
                        continue
                    bad += not _matches(_load(path), fired[n, i])
        return {"ckpt_mismatch": bad}

    def close(self) -> None:
        from vae_training_tpu_torch.runio.background import get_artifact_writer

        get_artifact_writer().drain_quietly()
        shutil.rmtree(self.out_root, ignore_errors=True)


CKPT_FILE, PREV_SUFFIX = "ckpt.pt", ".prev"  # what each save writes, and where it sets the last


def _fingerprint(state) -> dict:
    """What a checkpoint is compared by: a row's step, its Adam count, and
    each leaf's name, shape, type and sum of its bit patterns as integers
    (exact), the sums in one tensor on the state's device. ``state`` is a
    TrainState or a checkpoint's payload."""
    d = state if isinstance(state, dict) else vars(state)
    leaves = [(name, t) for tree in ("params", "m", "v") for name, t in sorted(d[tree].items())]
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return {"step": int(d["step"]), "count": int(d["count"]),
            "leaves": [(name, tuple(t.shape), t.dtype) for name, t in leaves],
            "sums": torch.stack([t.detach().contiguous().view(ints[t.element_size()])
                                 .sum(dtype=torch.int64) for _, t in leaves])}


def _matches(payload, want: dict) -> bool:
    """Whether a checkpoint's payload (None where the file is missing or
    unreadable) holds the state ``want`` was taken of."""
    try:
        got = _fingerprint(payload)
    except (TypeError, KeyError, AttributeError):
        return False
    return ([got[k] for k in ("step", "count", "leaves")] ==
            [want[k] for k in ("step", "count", "leaves")]
            and torch.equal(got["sums"], want["sums"].cpu()))


def _load(path: str):
    """A checkpoint file's payload, or None where there is none."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, EOFError, ValueError):
        return None


class SoloCell(Cell):
    """The ``solo`` kind: one Trainer, its state chained through
    ``train_chunk``."""

    def __init__(self, config, workload, seed, device):
        super().__init__(config, workload, seed, device)
        if len(self.rows) != 1:
            raise ValueError("a solo cell trains one row")
        from vae_training_tpu_torch.data import get_dataset
        from vae_training_tpu_torch.train.loop import Trainer

        dd, pd, ld, s = self.rows[0]
        cfg = run_config(config, workload, dd, pd, ld, s, seed, device)
        self.trainer = Trainer(cfg, get_dataset(cfg.dataset, s, cfg, device=self.device),
                               output_dir=".")

    def states(self):
        return [self.trainer.state]

    def call(self, n: int):
        self.trainer.state, losses = self.trainer.train_chunk(self.trainer.state, n)
        return [losses.cpu().numpy()]


KINDS = {"chunks": SweepCell, "cadence": CadenceCell, "solo": SoloCell}


def build(config: dict, workload: dict, seed: int, device: str) -> Cell:
    from vae_training_tpu_torch.config import use_fp32_math

    use_fp32_math(device)
    return KINDS[workload["kind"]](config, workload, seed, device)
