"""A whole mixed-dimension sweep in one kernel launch per chunk.

Port of ``vae_training_tpu/train/mixed_grid.py`` (``:42-113``, ``:225-318``,
``:320-423``, ``:425-543``). One ``GridTrainer`` per (data_dim,
padding_dim, latent_dim) row of the sweep owns its seeds' datasets, evals
and artifacts; training concatenates every group's rows into one launch
(each row carries its own dims in the kernel's row table) and splits them
back: K6a, the linear kernel's grid mode, for the linear sweep's 21 runs
and the sigmoid sweep's 18; K6b, the MLP kernel's grid mode, for the sphere
sweep's 15 (uniform 200|200|200 hidden widths, mixed D and L). Each trains
as one launch per chunk. The groups' saves go to the background writer
(``runio/background.py``); ``train`` drains it at the end and counts the
wait in plot+save.

There is no fallback after the choice: a row set outside both kernels'
envelopes raises ``MixedSweepUnavailable`` before any IO, a launch that
fails raises, and the JAX package's per-group insurance is not ported.

``mesh_spec`` (``dp=N``, the JAX package's ``_shard_rows``,
``mixed_grid.py:127-220``) shards the concatenated rows over the ranks:
the rows are padded to a multiple of N with duplicates of the leading
rows (row ``j`` of the padded list is row ``j mod n``), rank r trains the
contiguous block ``[r·k, (r+1)·k)`` of the padded list in one launch a
chunk with no collective, and the pads' results are discarded. A pad
trains a copy of its source row as the rank holds it (the row's current
state when the rank owns it, else its state at the start), so it never
touches a real row. Each rank evaluates, prints and writes only the real
rows of its block. Over several processes a mesh spanning every process is
required, as for ``--seed_grid``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Sequence, Tuple

from ..config import RunConfig
from ..kernels import linear_vae, mlp_vae
from ..kernels.dispatch import make_grid_chunk
from ..runio.background import get_artifact_writer
from ..utils import spans
from ..utils.process import barrier, process_index
from ..utils.spans import span
from .grid import GridTrainer, require_spanning_mesh, row_dirs
from .loop import next_event


class MixedSweepUnavailable(ValueError):
    """The row set is outside the one-launch kernel's envelope (raised by
    ``MixedGridSweep.__init__`` before any IO). Callers catch this, not a
    bare ValueError, so an error during training is never read as
    ineligibility."""


def _rows(groups: Sequence[GridTrainer]):
    """Every row's (model, dataset, config), group by group."""
    return ([g.model for g in groups for _ in g.seeds],
            [d for g in groups for d in g.datasets],
            [g.cfg for g in groups for _ in g.seeds])


def mixed_launch_eligible(groups: Sequence[GridTrainer]) -> Tuple[str, str]:
    """(family, reason): "linear" when every row of every group can share
    one K6a launch, "mlp" when they can share one K6b launch (each
    ``grid_supported``: the rows differ only in dims and seeds), ""
    otherwise, with the reason of the kernel the rows' shape belongs to."""
    if not groups:
        return "", "no rows"
    cfg = groups[0].cfg
    if cfg.kernels == "torch" or cfg.nojit:
        return "", "the torch path trains rows one by one (--kernels torch or -nojit)"
    models, datasets, cfgs = _rows(groups)
    ok, why_linear = linear_vae.grid_supported(models, datasets, cfgs)
    if ok:
        return "linear", why_linear
    ok, why_mlp = mlp_vae.grid_supported(models, datasets, cfgs)
    if ok:
        return "mlp", why_mlp
    hidden = any(len(m.encoder_features) > 1 or len(m.decoder_features) > 1 for m in models)
    return "", why_mlp if hidden else why_linear


def _clone(state):
    """A copy of a state whose tensors a launch may overwrite."""
    copy = lambda d: {k: t.clone() for k, t in d.items()}  # noqa: E731
    return replace(state, params=copy(state.params), m=copy(state.m), v=copy(state.v))


class MixedGridSweep:
    """Train many grid groups of different dims in one launch per chunk;
    with ``mesh_spec`` this rank's block of the rows (module docstring)."""

    def __init__(self, groups: List[GridTrainer], mesh_spec: str = ""):
        family, why = mixed_launch_eligible(groups)
        if not family:
            raise MixedSweepUnavailable(f"mixed one-launch sweep unavailable: {why}")
        self.groups = groups
        self.cfg: RunConfig = groups[0].cfg
        self.n_rows = sum(len(g.seeds) for g in groups)
        # (group, row) of every row of the sweep, then this rank's block
        every = [(g, i) for g in groups for i in range(len(g.seeds))]
        mesh = None
        if mesh_spec:
            from ..parallel.mesh import make_mesh, parse_mesh_spec

            if parse_mesh_spec(mesh_spec).get("tp", 1) > 1:
                raise MixedSweepUnavailable(
                    "mixed sweep shards rows over dp; use a pure dp spec")
            mesh = make_mesh(mesh_spec, allow_uneven=self.cfg.mesh_allow_uneven)
        require_spanning_mesh(mesh)
        block = list(range(self.n_rows))
        if mesh is not None:
            k = -(-self.n_rows // mesh.shape["dp"])
            r = mesh.coords(process_index())["dp"]
            block = list(range(r * k, (r + 1) * k))
        self._real = [every[j] for j in block if j < self.n_rows]
        self._pads = [every[j % self.n_rows] for j in block if j >= self.n_rows]
        for g in groups:
            g.rows = [i for h, i in self._real if h is g]
        mine = self._real + self._pads
        self._chunk = make_grid_chunk([g.model for g, _ in mine],
                                      [g.datasets[i] for g, i in mine],
                                      [g.cfg for g, _ in mine], prefix=groups[0].prefix)

    def run_chunk(self, n_steps: int) -> None:
        with span("sweep.chunk"):
            states = ([g.states[i] for g, i in self._real]
                      + [_clone(g.states[i]) for g, i in self._pads])
            states, losses = self._chunk(states, n_steps)
            with span("chunk.losses"):
                losses = losses.cpu().numpy()[:len(self._real)]  # the pads' work is discarded
                for (g, i), state in zip(self._real, states):
                    g.states[i] = state
                for g in self.groups:
                    at = [j for j, (h, _) in enumerate(self._real) if h is g]
                    g.record_losses(losses[at])

    def restore(self, outdirs_per_group: Sequence[Sequence[str]]) -> None:
        """Resume the whole sweep from every row's own checkpoint."""
        for g, outs in zip(self.groups, outdirs_per_group):
            g.restore(outs)
        steps = {g.batchnum for g in self.groups}
        if len(steps) != 1:
            raise ValueError(f"sweep groups checkpointed at different steps {sorted(steps)}")

    def train(self, outdirs_per_group: Sequence[Sequence[str]]) -> None:
        groups, g0 = self.groups, self.groups[0]
        since = spans.totals()  # where a one-launch sweep spends its wall time
        with span("sweep.banner"):
            for g in groups:
                g.maybe_print_banner()
        total = self.cfg.num_batches
        b, skip_at = g0.batchnum, g0._skip_events_at
        writer = get_artifact_writer()
        try:
            while b < total:
                for g in groups:
                    g.batchnum = b
                if b % g0.n_print == 0 and b != skip_at:
                    with span("sweep.eval", tag=b):
                        for g in groups:
                            g.compute_and_write_stats()
                if (b % g0.n_plot == 0 or b == total - 1) and b != skip_at:
                    with span("sweep.save", tag=b):
                        for g, outs in zip(groups, outdirs_per_group):
                            g.plot_all(outs)
                            g.save_all(outs)
                n = next_event(b, total, g0.n_print, g0.n_plot) - b
                self.run_chunk(n)  # ends in the losses' copy to the host
                b += n
        except BaseException:
            writer.drain_quietly()
            raise
        for g in groups:
            g.batchnum = max(total - 1, 0)
        with span("sweep.drain"):
            writer.drain()  # "train returned" means every in-loop write is on disk
        sec = {k: spans.seconds(f"sweep.{k}", since)
               for k in ("banner", "chunk", "eval", "save", "drain")}
        print(f"{g0.prefix}[sweep] wall accounting: banners {sec['banner']:.3f}s, train chunks "
              f"{sec['chunk']:.3f}s, stat evals {sec['eval']:.3f}s, plot+save "
              f"{sec['save'] + sec['drain']:.3f}s over {self.n_rows} rows (writes in the "
              f"background: plot+save counts the snapshots, the figures and the wait at the end)",
              flush=True)


def run_mixed_sweep(rows: Sequence[Tuple[RunConfig, Sequence[int], Dict[int, str]]],
                    mesh_spec: str = "", resume: bool = False) -> int:
    """One-launch sweep entry. ``rows`` = [(cfg, seeds, {seed: run name})].
    ``mesh_spec`` shards the launch's rows over a dp mesh of the run's
    ranks (the groups stay mesh-less: the sweep owns the sharding).
    ``resume`` continues every row from its own checkpoint. Raises
    ``MixedSweepUnavailable`` before any IO when the rows cannot share a
    launch; any other error propagates."""
    since = spans.totals()
    with span("sweep.setup"):
        groups = [GridTrainer(cfg, seeds, build_chunk=False) for cfg, seeds, _ in rows]
        sweep = MixedGridSweep(groups, mesh_spec=mesh_spec)  # raises if ineligible, before IO
    outdirs_per_group = [row_dirs(cfg, seeds, [names[s] for s in seeds], resume)
                         for cfg, seeds, names in rows]
    barrier()  # the primary made every row's directory; the others may write now
    if resume:
        sweep.restore(outdirs_per_group)
    sweep.train(outdirs_per_group)
    with span("sweep.final_save"):
        for g, outs in zip(groups, outdirs_per_group):
            g.save_all(outs, final=True)
    print(f"{groups[0].prefix}[sweep] wall accounting: setup "
          f"{spans.seconds('sweep.setup', since):.3f}s, final saves "
          f"{spans.seconds('sweep.final_save', since):.3f}s", flush=True)
    return 0
