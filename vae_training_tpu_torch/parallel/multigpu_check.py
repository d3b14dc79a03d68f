"""The parallel paths over NCCL on several cards of one host.

    python -m vae_training_tpu_torch.parallel.multigpu_check [--cards 4]

Every run takes ``--precision fp32``, so the check covers the parallel
paths apart from the dot mode. Through the CLI (``torchrun
--nproc_per_node N``, ``--multihost``: a gloo group for host objects and
an NCCL group a mesh axis for the device collectives):

  - sphere row 1 (200|200|200, 50 steps) under ``--mesh dp=N``,
    ``dp_dcn=2,dp=N/2``, ``dp=2,tp=N/2`` and ``tp=N``, each against the
    same run without a mesh in one process: the ``losses.npz`` trace and
    the final checkpoint's parameters, at the gloo tests' tolerances
    (``tests/test_torch_parallel_training.py``: dp's ``TOL``, tp's rtol
    2e-3 / atol 2e-4 on the losses and 5e-3 / 5e-4 on the parameters);
  - ``--seed_grid 2,3,4,5 --mesh dp=N`` at linear row 1 (200 steps; K6a, one
    launch a rank over its rows): every row's ``losses.npz`` and
    ``model.pkl`` equal the one-process grid's bitwise;
  - times (``--time``, N ranks under torchrun): the dp=N step at sphere row
    1, one CUDA graph replay a step with its NCCL all-reduce captured,
    against the no-mesh graph step on one card, in CUDA-event windows; and
    the all-reduce of a step's gradients alone (163,233 floats), in a CUDA
    graph of 100 calls.

It exits 0 when every check passed; ``--device cpu`` runs the same checks
over gloo on the CPU (no times), at a few steps, to develop them.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

SPHERE = ["--dataset", "sphere", "--encoder_layer_sizes", "200|200|200", "--layer_sizes",
          "200|200|200", "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3",
          "--epsilon", "-3", "-tdv", "-lr", "1e-4", "--precision", "fp32", "--batch_size", "96"]
LINEAR = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
          "-ow", "--latent_dim", "20", "--padding_dim", "9", "-dd", "3", "--epsilon", "-1",
          "-tdv", "-lr", "1e-3", "--precision", "fp32"]
# tests/test_torch_parallel_training.py's tolerances (rtol, atol)
DP_TOL = {"losses": (2e-4, 2e-4), "params": (5e-4, 5e-5)}
TP_TOL = {"losses": (2e-3, 2e-4), "params": (5e-3, 5e-4)}


def _cli(name, flags, n, data_dir, device, port, steps, extra=()):
    """The CLI in one process, or in n ranks under torchrun. Returns stdout."""
    argv = ["-m", "vae_training_tpu_torch._scripts.run", name, *flags, "--num_batches",
            str(steps), "--n_print", str(steps // 2), "--n_plot", str(steps), "--device", device,
            "--data_dir", data_dir, *extra]
    if n > 1:
        argv = ["-m", "torch.distributed.run", "--nproc_per_node", str(n), "--master_port",
                str(port), *argv, "--multihost"]
    proc = subprocess.run([sys.executable, *argv], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} ({n} ranks) exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return proc.stdout


def _close(a, b, tol, what):
    import numpy as np

    rtol, atol = tol
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        d = float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
        raise RuntimeError(f"{what}: max |Δ| {d:.3e} beyond rtol {rtol}, atol {atol}")
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def check_meshes(cards, data_dir, device, steps):
    """Sphere row 1 under each mesh against no mesh. Returns the max |Δ|s."""
    import numpy as np

    from ..runio.checkpoint import restore_checkpoint

    _cli("nomesh", SPHERE, 1, data_dir, device, 0, steps)
    ref = np.load(os.path.join(data_dir, "nomesh", "losses.npz"))
    ref_state = restore_checkpoint(os.path.join(data_dir, "nomesh"))
    meshes = [f"dp={cards}", f"dp_dcn=2,dp={cards // 2}", f"dp=2,tp={cards // 2}",
              f"tp={cards}"]
    out = {}
    for i, mesh in enumerate(meshes):
        name = "mesh_" + mesh.replace(",", "_").replace("=", "")
        t = time.perf_counter()
        stdout = _cli(name, SPHERE, cards, data_dir, device, 29511 + i, steps,
                      ["--mesh", mesh])
        secs = time.perf_counter() - t
        kline = [ln for ln in stdout.splitlines() if ln.startswith("[kernels]")]
        tol = TP_TOL if "tp" in mesh else DP_TOL
        got = np.load(os.path.join(data_dir, name, "losses.npz"))
        state = restore_checkpoint(os.path.join(data_dir, name))
        err = {"losses": _close(got["VAE Loss"], ref["VAE Loss"], tol["losses"],
                                f"{mesh} losses")}
        err["params"] = max(_close(t.numpy(), ref_state.params[k].numpy(), tol["params"],
                                   f"{mesh} params[{k}]") for k, t in state.params.items())
        out[mesh] = err
        print(f"--mesh {mesh}: {kline[0] if kline else 'no [kernels] line'}; {secs:.1f} s; "
              f"against no mesh max |Δ| losses {err['losses']:.3e}, params "
              f"{err['params']:.3e} (rtol, atol {tol})", flush=True)
    return out


def check_grid(cards, data_dir, device, steps):
    """--seed_grid over dp=cards ranks against one process, bitwise."""
    import numpy as np

    seeds = "2,3,4,5"
    one, sharded = os.path.join(data_dir, "grid1"), os.path.join(data_dir, "gridN")
    _cli("g", LINEAR, 1, one, device, 0, steps, ["--seed_grid", seeds])
    stdout = _cli("g", LINEAR, cards, sharded, device, 29531, steps,
                  ["--seed_grid", seeds, "--mesh", f"dp={cards}"])
    klines = [ln for ln in stdout.splitlines() if "[kernels]" in ln]
    for s in seeds.split(","):
        a = np.load(os.path.join(one, f"g_seed{s}", "losses.npz"))
        b = np.load(os.path.join(sharded, f"g_seed{s}", "losses.npz"))
        if set(a.files) != set(b.files) or any(not np.array_equal(a[k], b[k]) for k in a.files):
            raise RuntimeError(f"seed {s}: losses.npz differs from the one-process grid's")
        with open(os.path.join(one, f"g_seed{s}", "model.pkl"), "rb") as f:
            pa = pickle.load(f)
        with open(os.path.join(sharded, f"g_seed{s}", "model.pkl"), "rb") as f:
            pb = pickle.load(f)
        if pickle.dumps(pa["target"]) != pickle.dumps(pb["target"]):
            raise RuntimeError(f"seed {s}: model.pkl differs from the one-process grid's")
    print(f"--seed_grid {seeds} --mesh dp={cards}: every row bitwise the one-process grid's; "
          f"{klines[:cards]}", flush=True)


def rank_times(steps: int) -> None:
    """One rank of ``--time``: the dp step over the world, the all-reduce
    alone, and on rank 0 the no-mesh step; rank 0 prints one JSON line."""
    import torch
    import torch.distributed as dist

    from ..config import RunConfig, use_fp32_math
    from ..data import SphereDataset
    from ..models import build_vae
    from ..ops import rng
    from ..train import TrainState, step as torch_step
    from ..utils.process import device_group, init_distributed, process_index
    from .api import make_parallel_step_fns

    init_distributed(True, "cuda")
    world, rank = dist.get_world_size(), process_index()
    dev = torch.device("cuda", torch.cuda.current_device())
    use_fp32_math(dev)
    model = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="200|200|200",
                      decoder_layer_sizes="200|200|200", epsilon=-3.0,
                      tunable_decoder_var=True)
    model.init_parameters(0)
    model.to(dev)
    ds = SphereDataset(3, 3, device=dev)
    batch = 96

    def fresh():
        return TrainState.create(dict(model.named_parameters()),
                                 rng.derive_seed(69, rng.SEED_TRAIN_DATA),
                                 rng.derive_seed(0, rng.SEED_TRAIN_Z))

    def ms_a_step(chunk, state):
        chunk(state, 100)  # capture and warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chunk(state, steps)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps

    cfg = RunConfig(mesh=f"dp={world}", batch_size=batch, learning_rate=1e-4, device="cuda",
                    dataset="sphere", precision="fp32").validate()
    fns = make_parallel_step_fns(model, ds, cfg, graph=True, form="graph")
    out = {"world": world, "dp_ms": [ms_a_step(fns.train_chunk, fns.place_state(fresh()))
                                     for _ in range(2)]}
    group = device_group(range(world), dev)
    n = sum(p.numel() for p in model.parameters())
    buf = torch.ones(n, device=dev)
    dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            for _ in range(100):
                dist.all_reduce(buf, group=group)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    end.synchronize()
    out["allreduce_us"] = 1e3 * start.elapsed_time(end) / 1000
    out["allreduce_floats"] = n
    dist.barrier()
    if rank == 0:
        single = torch_step.GraphChunk(model, ds, batch_size=batch, lr=1e-4)
        out["nomesh_ms"] = [ms_a_step(single, fresh()) for _ in range(2)]
        print("TIMES " + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--steps", type=int, default=50, help="steps of the mesh runs")
    p.add_argument("--time", action="store_true", help="the timing ranks (under torchrun)")
    args = p.parse_args(argv)
    if args.time:
        rank_times(2000)
        return 0
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.cards:
            print(f"{torch.cuda.device_count()} CUDA devices; --cards {args.cards} needs "
                  f"that many", file=sys.stderr)
            return 2
    data_dir = tempfile.mkdtemp()
    try:
        check_meshes(args.cards, data_dir, args.device, args.steps)
        check_grid(args.cards, data_dir, args.device, 4 * args.steps)
        if args.device == "cuda":
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                 str(args.cards), "--master_port", "29541", "-m",
                 "vae_training_tpu_torch.parallel.multigpu_check", "--time"],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"--time exited {proc.returncode}:\n{proc.stderr[-6000:]}")
            (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith("TIMES ")]
            t = json.loads(line[len("TIMES "):])
            print(f"sphere row 1, batch 96, one CUDA graph replay a step, 2000 steps a window: "
                  f"dp={t['world']} {t['dp_ms']} ms a step, no mesh (one card) "
                  f"{t['nomesh_ms']} ms a step; the all-reduce of {t['allreduce_floats']} "
                  f"floats alone {t['allreduce_us']:.3f} µs (a CUDA graph of 100 calls)")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    print("RESULT: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
