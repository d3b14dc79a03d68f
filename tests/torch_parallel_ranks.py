"""Rank workers for the port's multi-process tests (tests/test_torch_parallel_*.py).

Each test starts n copies of this script as the ranks of one gloo process
group (``vae_training_tpu_torch.parallel.dryrun.spawn_ranks``: RANK,
WORLD_SIZE and a ``file://`` VAE_INIT_METHOD). It imports torch and the
port only, never JAX, so that a rank starts in a few seconds.

    python torch_parallel_ranks.py train <dir>     # inputs.pt → train_rank<r>.pt
    python torch_parallel_ranks.py checks <dir>    # the refusals → checks_rank<r>.json
    python torch_parallel_ranks.py cli <dir> <argv>    # vae-train-torch; "{rank}" in argv
    python torch_parallel_ranks.py sweep <dir> <argv>  # vae-sweep-torch
                                                   # → writes_rank<r>.json
"""

import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist

from vae_training_tpu_torch.utils.process import init_distributed, process_index


def _clone(state):
    """A copy of a TrainState that training may update in place."""
    copy = lambda d: {k: t.clone() for k, t in d.items()}  # noqa: E731
    return dataclasses.replace(state, params=copy(state.params), m=copy(state.m),
                               v=copy(state.v))


def _flat(state):
    """A TrainState as a dict of host tensors, for torch.save."""
    return {"params": {k: t.detach().clone() for k, t in state.params.items()},
            "m": {k: t.detach().clone() for k, t in state.m.items()},
            "v": {k: t.detach().clone() for k, t in state.v.items()},
            "step": state.step, "count": state.count}


def train(workdir):
    """Every multi-rank training case the tests hold against the JAX
    package or the port's single device, in one process group."""
    from vae_training_tpu_torch.config import RunConfig
    from vae_training_tpu_torch.data import ImageDataset, LinearGaussianDataset
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.models.conv import build_conv_vae
    from vae_training_tpu_torch.ops.flows import InvertibleBatchNorm
    from vae_training_tpu_torch.parallel import data_parallel, make_mesh
    from vae_training_tpu_torch.parallel.api import make_parallel_step_fns
    from vae_training_tpu_torch.train import step as torch_step

    rank = process_index()
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}

    # dp against JAX: each rank fed its shard of the global noise
    hook = inp["dp_hook"]
    model = build_vae(**hook["model"])
    ds = LinearGaussianDataset.create(2, 3, 3, hook["padding"])
    for mesh in ("dp=4", "dp_dcn=2,dp=2"):
        dp = data_parallel(make_mesh(mesh), hook["batch"], rank, "cpu")
        rows = slice(dp.row0, dp.row0 + dp.local_batch)
        noise = tuple(torch.as_tensor(a[:, rows]) for a in hook["noise"])
        state, losses = torch_step.train_chunk(model, ds, _clone(hook["state"]),
                                               hook["steps"], batch_size=hook["batch"],
                                               lr=hook["lr"], noise=noise, dp=dp)
        out[f"hook {mesh}"] = {"losses": losses, **_flat(state)}

    # dp with the port's own streams (and the batch that does not divide)
    streams = inp["dp_streams"]
    model = build_vae(**streams["model"])
    ds = LinearGaussianDataset.create(**streams["dataset"])
    for mesh in ("dp=4", "dp_dcn=2,dp=2"):
        dp = data_parallel(make_mesh(mesh), streams["batch"], rank, "cpu")
        state, losses = torch_step.train_chunk(model, ds, _clone(streams["state"]),
                                               streams["steps"],
                                               batch_size=streams["batch"],
                                               lr=streams["lr"], dp=dp)
        out[f"streams {mesh}"] = {"losses": losses, **_flat(state)}
    for mesh in ("dp=4", "dp_dcn=2,dp=2"):
        try:
            data_parallel(make_mesh(mesh), 30, rank, "cpu")
        except ValueError as e:
            out[f"indivisible {mesh}"] = str(e)

    # tensor parallelism, dp×tp and tp alone
    tp = inp["tp"]
    model = build_vae(**tp["model"])
    ds = LinearGaussianDataset.create(**tp["dataset"])
    for mesh in ("dp=2,tp=2", "tp=4"):
        cfg = RunConfig(mesh=mesh, batch_size=tp["batch"], learning_rate=tp["lr"],
                        device="cpu", kernels="torch")
        fns = make_parallel_step_fns(model, ds, cfg, graph=False, form="eager")
        local = fns.place_state(_clone(tp["state"]))
        shard_shape = tuple(local.params["Encoder.FC0.kernel"].shape)
        local, losses = fns.train_chunk(local, tp["steps"])
        out[f"tp {mesh}"] = {"losses": losses, "shard": shard_shape,
                             **_flat(fns.full_state(local))}

    # the epoch chunk's dp branch on a small conv corpus
    ep = inp["epoch"]
    ds = ImageDataset.synthetic_digits(0, n=ep["n"], size=ep["size"])
    model = build_conv_vae(image_hwc=ds.shape, **ep["model"])
    model.init_parameters(0)
    dp = data_parallel(make_mesh("dp=4"), ep["batch"], rank, "cpu")
    chunk = torch_step.EpochChunk(model, ds, batch_size=ep["batch"], lr=ep["lr"],
                                  graph=False, dp=dp)
    state, losses = _clone(ep["state"]), []
    for epoch in range(2):
        state, ls = chunk(state, epoch)
        losses.append(ls)
    out["epoch"] = {"losses": torch.cat(losses), **_flat(state)}

    # InvertibleBatchNorm with a gloo group
    bn_in = inp["bn"]
    bn = InvertibleBatchNorm(bn_in["x"].shape[1], process_group=dist.group.WORLD)
    lb = bn_in["x"].shape[0] // dist.get_world_size()
    x = torch.as_tensor(bn_in["x"][rank * lb:(rank + 1) * lb]).requires_grad_(True)
    y = bn(x)
    (y * torch.as_tensor(bn_in["w"][rank * lb:(rank + 1) * lb])).sum().backward()
    out["bn"] = {"y": y.detach(), "x_grad": x.grad, "scale_grad": bn.scale.grad,
                 "bias_grad": bn.bias.grad,
                 **{k: b.clone() for k, b in bn.named_buffers()}}
    torch.save(out, os.path.join(workdir, f"train_rank{rank}.pt"))


def checks(workdir):
    """The refusals that need several ranks: check_shared_fs in both its
    forms, and the seed grid's mesh rules."""
    from vae_training_tpu_torch.config import RunConfig
    from vae_training_tpu_torch.train.grid import GridTrainer
    from vae_training_tpu_torch.utils.process import check_shared_fs

    rank = process_index()
    got = {}

    def record(name, fn):
        try:
            fn()
            got[name] = None
        except ValueError as e:
            got[name] = str(e)

    record("shared one", lambda: check_shared_fs(rank == 0, "/runs/r"))
    record("shared rows", lambda: check_shared_fs([True, rank == 0, True], "/runs",
                                                  what="grid row checkpoints"))
    record("shared agree", lambda: check_shared_fs([True, False], "/runs"))
    grid = RunConfig(name="g", dataset="linear_gaussian", encoder_layer_sizes="",
                     layer_sizes="", latent_dimension=4, padding_dim=2, dataset_dimension=2,
                     num_batches=2, batch_size=8, device="cpu", multihost=True, tqdm=False)
    for name, mesh, seeds in (("indivisible", "dp=2", [2, 3, 4]),
                              ("no mesh", "", [2, 3]),
                              ("not spanning", "dp=1", [2, 3])):
        record(name, lambda: GridTrainer(dataclasses.replace(grid, mesh=mesh), seeds))
    with open(os.path.join(workdir, f"checks_rank{rank}.json"), "w") as f:
        json.dump(got, f)


def record_writes(workdir, entry, argv):
    """Run an entry point with every artifact save recorded: the run
    directories this rank wrote losses.npz, model.pkl and checkpoints into."""
    from vae_training_tpu_torch.evals.stats import StatsRecorder
    from vae_training_tpu_torch.train import grid, loop

    rank = int(os.environ["RANK"])  # the entry point ends its process group
    writes = []

    def recorded(kind, fn):
        def wrapper(path, *args, **kwargs):
            writes.append([kind, os.path.basename(os.path.normpath(
                os.path.dirname(path) if kind == "model.pkl" else path))])
            return fn(path, *args, **kwargs)
        return wrapper

    for mod in (grid, loop):
        mod.save_model_pkl = recorded("model.pkl", mod.save_model_pkl)
        mod.save_checkpoint = recorded("checkpoint", mod.save_checkpoint)
    save_npz = StatsRecorder.save_npz
    StatsRecorder.save_npz = lambda self, d, *a, **k: (
        writes.append(["losses.npz", os.path.basename(os.path.normpath(d))]),
        save_npz(self, d, *a, **k))[1]
    rc = entry([a.replace("{rank}", str(rank)) for a in argv])
    with open(os.path.join(workdir, f"writes_rank{rank}.json"), "w") as f:
        json.dump(sorted(set(map(tuple, writes))), f)
    return rc


def main():
    scenario, workdir, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
    if scenario == "cli":
        from vae_training_tpu_torch._scripts.run import cli

        return record_writes(workdir, cli, argv)
    if scenario == "sweep":
        from vae_training_tpu_torch._scripts.sweep import main as sweep

        return record_writes(workdir, sweep, argv)
    init_distributed(True, "cpu")
    try:
        {"train": train, "checks": checks}[scenario](workdir)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
