"""The multi-rank dry run over gloo, and a launcher of ranks.

The gloo twin of the JAX package's ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:64-250``): run in n ranks of a process group,
``dryrun_multichip(n)`` takes one training step of each parallel path on
tiny shapes, with the JAX function's asserts:

  1. dp × tp (tp = 2 when n is even and at least 4): the Dense kernels
     sharded over tp, the batch over dp;
  2. dp = n: a shard of the batch a rank, the gradients all-reduced;
  3. the sharded seed grid (``--seed_grid`` with ``--mesh dp=n``): each
     rank's two rows on the torch path, then on K6a's plain version, each
     row bitwise the same row trained alone;
  4. dp_dcn = 2, dp = n/2 (n even and at least 4): the two-level mesh,
     ``dp_dcn`` its leading axis.

    python -m vae_training_tpu_torch.parallel.dryrun 4

starts 4 ranks of itself on the CPU (``spawn_ranks``: a ``file://``
init_method in a fresh directory, a timeout on every join) and exits 0
when every rank passed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple


def spawn_ranks(n: int, argv: Sequence[str], *, timeout: float = 120.0,
                env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
                local_rank=None) -> List[Tuple[int, str, str]]:
    """Run ``argv`` as ranks 0..n-1 of one process group: each process gets
    RANK, WORLD_SIZE, LOCAL_RANK (its rank, or ``local_rank``) and a
    ``file://`` ``VAE_INIT_METHOD`` in a fresh directory. Returns every
    rank's (exit code, stdout, stderr). A rank that is still running at
    ``timeout`` seconds is killed with the others, and TimeoutError raised."""
    with tempfile.TemporaryDirectory() as tmp:
        base = dict(os.environ, WORLD_SIZE=str(n),
                    VAE_INIT_METHOD=f"file://{os.path.join(tmp, 'rendezvous')}")
        base.update(env or {})
        procs, files = [], []
        for r in range(n):
            out = open(os.path.join(tmp, f"out{r}"), "w+")
            err = open(os.path.join(tmp, f"err{r}"), "w+")
            files.append((out, err))
            rank_env = dict(base, RANK=str(r),
                            LOCAL_RANK=str(r if local_rank is None else local_rank))
            procs.append(subprocess.Popen(list(argv), stdout=out, stderr=err, env=rank_env,
                                          cwd=cwd))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"{n} ranks of {list(argv)} still running after "
                               f"{timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
        return results


def dryrun_multichip(n_devices: int) -> None:
    """One step of every parallel path in this rank of ``n_devices``
    (the process group is up, one rank a device, the CPU)."""
    import dataclasses

    import torch

    from ..config import RunConfig
    from ..data import SphereDataset
    from ..models import build_vae
    from ..ops import rng
    from ..train import TrainState
    from ..utils.process import process_count
    from .api import make_parallel_step_fns

    if process_count() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs in {n_devices} ranks of a "
                           f"process group, found {process_count()}; start it with "
                           f"python -m vae_training_tpu_torch.parallel.dryrun {n_devices}")
    dataset = SphereDataset(dim=3, padding_dim=5)
    model = build_vae(data_dim=dataset.dimension, latent_dim=4, encoder_layer_sizes="16|16",
                      decoder_layer_sizes="16|16", epsilon=-3.0, tunable_decoder_var=True,
                      dataset_name="sphere")
    model.init_parameters(0)
    base = RunConfig(device="cpu", learning_rate=1e-3, kernels="torch")

    def fresh_state():
        return TrainState.create(dict(model.named_parameters()),
                                 data_seed=rng.derive_seed(2, rng.SEED_TRAIN_DATA),
                                 model_seed=rng.derive_seed(1, rng.SEED_TRAIN_Z))

    def one_step(mesh: str, batch: int):
        cfg = dataclasses.replace(base, mesh=mesh, batch_size=batch)
        fns = make_parallel_step_fns(model, dataset, cfg, graph=False, form="eager")
        state, losses = fns.train_chunk(fns.place_state(fresh_state()), 1)
        assert losses.shape == (1,) and bool(torch.isfinite(losses[0])), losses
        assert state.step == 1
        return fns

    # 1) dp × tp: the Dense kernels sharded over tp, the batch over dp
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // tp
    fns = one_step(f"dp={dp},tp={tp}", 2 * dp)
    if tp > 1:
        assert fns.kind.startswith("tensor parallel"), fns.kind
    # 2) dp = n: a shard of the batch a rank, the gradients all-reduced
    assert one_step(f"dp={n_devices}", 2 * n_devices).kind.startswith("data parallel")
    # 3) the sharded seed grid: two rows a rank, no collective, on the torch
    #    path and then on K6a's plain version, each row bitwise alone
    _grid_rows(n_devices)
    # 4) two-level data parallelism, dp_dcn leading
    if n_devices % 2 == 0 and n_devices >= 4:
        fns = one_step(f"dp_dcn=2,dp={n_devices // 2}", 2 * n_devices)
        assert fns.mesh.axis_names[0] == "dp_dcn"


def _grid_rows(n_devices: int) -> None:
    import torch

    from ..config import RunConfig
    from ..kernels.dispatch import make_grid_chunk
    from ..train.grid import GridTrainer

    for kernels in ("torch", "auto"):
        cfg = RunConfig(
            name="dryrun_grid", dataset="linear_gaussian", encoder_layer_sizes="",
            layer_sizes="", latent_dimension=4, padding_dim=2, dataset_dimension=2,
            dataset_intrinsic_dimension=2, num_batches=4, batch_size=8,
            learning_rate=1e-3, epsilon=-1.0, tunable_decoder_var=True, tqdm=False,
            mesh=f"dp={n_devices}", kernels=kernels, device="cpu")
        trainer = GridTrainer(cfg, list(range(2, 2 + 2 * n_devices)))
        assert len(trainer.rows) == 2, trainer.rows
        alone = [trainer.states[i].host_copy() for i in trainer.rows]
        trainer.run_chunk(2)
        for i, state in zip(trainer.rows, alone):
            assert trainer.states[i].step == 2
            losses = torch.as_tensor(trainer.recorders[i].vae_losses[-1])
            assert losses.shape == (2,) and bool(torch.isfinite(losses).all()), losses
            chunk = make_grid_chunk([trainer.model], [trainer.datasets[i]], cfg)
            (solo,), solo_losses = chunk([state], 2)
            assert torch.equal(losses, solo_losses[0]), (kernels, i)
            for k, t in solo.params.items():
                assert torch.equal(t, trainer.states[i].params[k]), (kernels, i, k)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    if "RANK" not in os.environ:  # the launcher: n ranks of this module
        results = spawn_ranks(n, [sys.executable, "-m", "vae_training_tpu_torch.parallel.dryrun",
                                  str(n)])
        for r, (rc, out, err) in enumerate(results):
            if rc != 0:
                print(f"rank {r} failed (exit {rc}):\n{err}", file=sys.stderr)
        ok = all(rc == 0 for rc, _, _ in results)
        print(f"dryrun_multichip({n}) over gloo: {'ok' if ok else 'FAILED'}")
        return 0 if ok else 1
    import torch.distributed as dist

    from ..utils.process import init_distributed

    init_distributed(True, "cpu")
    try:
        dryrun_multichip(n)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
