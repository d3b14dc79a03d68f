#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one Hopper GPU.

    python3 chip_smoke.py

Drives the port's main path (the reference CLI's headline run: row 1 of
seed_linpadding_expts.sh) on the card, through the fused CUDA kernel K1
(vae_training_tpu_torch/csrc/linear_vae.cu), in seven phases:

  1. device: CUDA, compute capability 9.0, TF32 off;
  2. build: nvcc builds the kernel library from the checkout's sources;
  3. sampler: the kernel's Philox words equal ops/rng.py's bitwise, its
     normals agree to 1e-5, and 4M kernel normals have the right moments;
  4. parity: the kernel against its plain PyTorch version on the card,
     from the same state, 64 steps, external noise and in-kernel sampling,
     -tdv on and off;
  5. main path: the CLI's main() for 12000 steps with --kernels cuda; K1
     must launch and the plain path must not run; the artifacts must exist
     and the eval loss and padding norm must fall;
  6. resume: 7000 steps, then --resume to 12000, equal to phase 5 bitwise;
  7. times: kernel and torch-path steps/s at the slice's shapes.

Imports no JAX. Every check raises on failure, so any failed phase exits
nonzero. The last two stdout lines are JSON: the kernels' record, then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "",
        "--layer_sizes", "", "-ow", "--latent_dim", "20", "--padding_dim", "9",
        "-dd", "3", "--epsilon", "-1", "-tdv", "-ds", "2", "-lr", "1e-3"]
B, D, L, ID = 100, 12, 20, 3  # the slice's shapes: batch, ambient, latent, intrinsic
# tests/test_pallas_kernel.py's tolerances (fp32 on both sides)
TOL = {"losses": (2e-4, 2e-4), "params": (5e-4, 5e-5), "m": (5e-4, 1e-6),
       "v": (5e-4, 1e-7)}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


_T0 = time.perf_counter()


def phase(n: int, title: str) -> None:
    print(f"\n== phase {n}: {title} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from vae_training_tpu_torch._scripts.run import main as run_main
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.data import LinearGaussianDataset
    from vae_training_tpu_torch.kernels import linear_vae as k1
    from vae_training_tpu_torch.kernels._build import load_library
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.ops import rng
    from vae_training_tpu_torch.train import TrainState, step as torch_step

    # --- 1 ---------------------------------------------------------------
    phase(1, "device")
    dev = torch.device("cuda")
    cap = torch.cuda.get_device_capability(dev)
    require(tuple(cap) == (9, 0), f"compute capability 9.0 (got {cap})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 2 ---------------------------------------------------------------
    phase(2, "build")
    t0 = time.perf_counter()
    _, record = load_library("linear_vae")
    print(f"built={record['built']} in {record['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s): {record['path']}")
    for line in record["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    need = k1.smem_bytes(B, D, L, ID, ID)
    require(k1.kernel_smem_bytes(B, D, L, ID, ID) == need,
            "shared-memory layout of the library equals kernels/linear_vae.py's")
    print(f"shared memory per launch at the slice's shapes: {need} B")

    # --- 3 ---------------------------------------------------------------
    phase(3, "sampler: in-kernel Philox vs ops/rng.py")
    for seed, step, stream in ((0, 0, 0), (2**64 - 1, 4_000_000_000, 3),
                               (rng.derive_seed(2, 1), 11999, 1), (12345, 77, 2)):
        words, normals = k1.sampler_check(100, 6, step, stream, seed, dev)
        ref = rng.words(seed, step, 100, stream, 6)
        require(torch.equal(words.cpu(), ref), f"words bitwise at {(seed, step, stream)}")
        err = (normals.cpu() - rng.box_muller(ref)).abs().max().item()
        require(err <= 1e-5, f"normals |Δ| {err} <= 1e-5 at {(seed, step, stream)}")
    print("words bitwise equal; normals within 1e-5")
    _, big = k1.sampler_check(65536, 16, 5, 0, 987654321, dev)  # 4M normals
    big = big.reshape(-1, 4).double()
    mean, std = big.mean().item(), big.std().item()
    rho = max(abs(torch.corrcoef(big[:, [a, b]].T)[0, 1].item()) for a, b in ((0, 1), (2, 3)))
    print(f"4M kernel normals: mean {mean:.2e}, std-1 {std - 1:.2e}, partner |rho| {rho:.2e}")
    require(abs(mean) < 3e-3 and abs(std - 1) < 3e-3 and rho < 3e-3, "normal moments")

    # --- 4 ---------------------------------------------------------------
    phase(4, "kernel vs plain PyTorch version on the card (64 steps)")
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=dev)
    data_seed, model_seed = rng.derive_seed(2, rng.SEED_TRAIN_DATA), rng.derive_seed(0, rng.SEED_TRAIN_Z)

    def flat_state(tdv):
        model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=tdv)
        model.init_parameters(0)
        return k1.pack_state(TrainState.create(dict(model.named_parameters()), 0, 0).to(dev), D, L)

    def chunk(fn, bufs, n, step0, tdv, noise=None, var_added=0.0):
        return fn(*bufs, ds.A, n_steps=n, batch=B, data_dim=D, latent_dim=L,
                  intrinsic_dim=ID, manifold_dim=ID, step0=step0, t0=step0,
                  data_seed=data_seed, model_seed=model_seed, var_added=var_added,
                  eps_const=-1.0, tdv=tdv, lr=1e-3, external_noise=noise)

    max_err = 0.0
    n = 64
    rs = np.random.RandomState(0)
    xs = np.zeros((n, B, D), np.float32)
    xs[:, :, :3] = rs.randn(n, B, 3).astype(np.float32) @ ds.A.cpu().numpy().T
    ext = tuple(torch.as_tensor(a, device=dev) for a in (
        xs, rs.randn(n, B, L).astype(np.float32), rs.randn(n, B, D).astype(np.float32)))
    for tdv in (True, False):
        for mode, noise, var_added in (("external", ext, 0.0), ("sampler", None, 0.0),
                                       ("sampler+obs", None, 0.25)):
            kb = flat_state(tdv)
            pb = tuple(t.clone() for t in kb)
            kl = chunk(k1.run_fused_chunk, kb, n, 0, tdv, noise, var_added)
            pl = chunk(k1.plain_fused_chunk, pb, n, 0, tdv, noise, var_added)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in (("losses", kl, pl), ("params", kb[0], pb[0]),
                               ("m", kb[1], pb[1]), ("v", kb[2], pb[2])):
                a, b = a.cpu().numpy(), b.cpu().numpy()
                require(bool(np.all(np.isfinite(a))), f"{name} finite")
                np.testing.assert_allclose(a, b, *TOL[name],
                                           err_msg=f"{name} tdv={tdv} {mode}")
                errs.append(float(np.abs(a - b).max()))
            max_err = max(max_err, *errs)
            print(f"tdv={tdv!s:5} {mode:11}: max |Δ| losses {errs[0]:.2e} params "
                  f"{errs[1]:.2e} m {errs[2]:.2e} v {errs[3]:.2e}")
    a = flat_state(True)
    b = tuple(t.clone() for t in a)
    la = chunk(k1.run_fused_chunk, a, 40, 0, True)
    lb = torch.cat([chunk(k1.run_fused_chunk, b, 15, 0, True),
                    chunk(k1.run_fused_chunk, b, 25, 15, True)])
    torch.cuda.synchronize()
    require(torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(a, b)),
            "a 40-step launch equals a 15 + 25 split bitwise")
    print("chunk split 40 = 15 + 25: bitwise equal")

    # --- 5 ---------------------------------------------------------------
    phase(5, "main path: the CLI, 12000 steps, --kernels cuda --device cuda")
    tmp = tempfile.TemporaryDirectory()
    data_dir = tmp.name

    def cli(name, num_batches, *extra):
        cfg = parse_arguments([name, *ROW1, "--num_batches", str(num_batches),
                               "--kernels", "cuda", "--device", "cuda",
                               "--data_dir", data_dir, *extra])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cfg)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t

    k1.run_fused_chunk.launches = 0
    torch_step.train_chunk.calls = 0
    rc, out, secs = cli("main", 12000)
    launches, plain_calls = k1.run_fused_chunk.launches, torch_step.train_chunk.calls
    batch_lines = [ln for ln in out.splitlines() if ln.startswith(("Batch |", "[kernels]", "Score"))]
    print("\n".join(batch_lines))
    print(f"main path: rc {rc}, {secs:.2f} s, K1 launches {launches}, "
          f"plain-path chunks {plain_calls}")
    require(rc == 0, "main() returned 0")
    require(launches > 0, "K1 launched on the main path")
    require(plain_calls == 0, "the plain path did not run on the main path")
    run_dir = os.path.join(data_dir, "main")
    for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json"):
        require(os.path.exists(os.path.join(run_dir, f)), f"artifact {f}")
    evals = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^Batch \| (\d+) \| VAE Loss \| (-?[\d.]+)", out, re.M)}
    z = np.load(os.path.join(run_dir, "losses.npz"))
    pad = z["Squared Norm of padding dimensions"]
    require(sorted(evals) == [0, 5000, 10000], f"eval lines at 0/5000/10000 ({sorted(evals)})")
    require(evals[10000] < evals[0], "eval VAE Loss lower at 10000 than at 0")
    require(pad[2] < pad[0], "padding norm lower at 10000 than at 0")
    require(bool(np.all(np.isfinite(z["VAE Loss"]))) and z["VAE Loss"].shape == (12003,),
            "finite per-step loss trace of 12000 steps + 3 evals")
    print(f"eval VAE Loss {evals[0]:.3f} -> {evals[10000]:.3f}; padding norm "
          f"{pad[0]:.4f} -> {pad[2]:.6f}")

    # --- 6 ---------------------------------------------------------------
    phase(6, "resume: 7000 steps, then --resume to 12000")
    rc1, _, _ = cli("part", 7000)
    rc2, _, _ = cli("resumed", 12000, "--resume", os.path.join(data_dir, "part"))
    require(rc1 == 0 and rc2 == 0, "both runs returned 0")
    za = np.load(os.path.join(run_dir, "losses.npz"))
    zb = np.load(os.path.join(data_dir, "resumed", "losses.npz"))
    require(set(za.files) == set(zb.files), "same npz channels")
    for k in za.files:
        require(np.array_equal(za[k], zb[k]), f"losses.npz {k!r} bitwise equal")
    with open(os.path.join(run_dir, "model.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(data_dir, "resumed", "model.pkl"), "rb") as f:
        pb = pickle.load(f)
    for name in pa["target"]:
        for x, y in zip(_leaves(pa["target"][name]), _leaves(pb["target"][name])):
            require(np.array_equal(x, y), f"model.pkl {name} bitwise equal")
    print("losses.npz and model.pkl params equal the uninterrupted run bitwise")
    tmp.cleanup()

    # --- 7 ---------------------------------------------------------------
    phase(7, "times at the slice's shapes (batch 100, D 12, L 20)")
    kb = flat_state(True)
    chunk_steps = 5000

    def kernel_call():
        chunk(k1.run_fused_chunk, kb, chunk_steps, 0, True)

    model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), data_seed, model_seed).to(dev)
    torch_steps = 100

    def torch_call():
        torch_step.train_chunk(model, ds, state, torch_steps, batch_size=B, lr=1e-3)

    rates = {}
    for name, fn, steps in (("plain", torch_call, torch_steps), ("kernel", kernel_call, chunk_steps),
                            ("kernel2", kernel_call, chunk_steps), ("plain2", torch_call, torch_steps)):
        rates[name] = _steps_per_second(torch, fn, steps)
    k_rate = max(rates["kernel"], rates["kernel2"])
    p_rate = max(rates["plain"], rates["plain2"])
    print(f"card: {smi}")
    print(f"K1 kernel:  {rates['kernel']:.1f} / {rates['kernel2']:.1f} steps/s "
          f"({1e3 / k_rate:.5f} ms/step, {chunk_steps}-step launches)")
    print(f"torch path: {rates['plain']:.1f} / {rates['plain2']:.1f} steps/s "
          f"({1e3 / p_rate:.5f} ms/step)")

    record = {"kernels": [{
        "name": "linear_vae_chunk (K1)", "route": "cuda",
        "source": "vae_training_tpu_torch/csrc/linear_vae.cu",
        "replaces": "vae_training_tpu/kernels/linear_vae.py:678",
        "launches": launches, "max_abs_err": max_err,
        "ms": 1e3 / k_rate, "plain_ms": 1e3 / p_rate}]}
    print(f"all phases passed in {time.perf_counter() - _T0:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _steps_per_second(torch, fn, steps_per_call: int, min_seconds: float = 1.0) -> float:
    """Training steps per second over a window of at least ``min_seconds``
    of device time, timed with CUDA events after one warm-up call. Each call
    is waited for, so the queue never runs ahead of the window."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls = 0
    start.record()
    while True:
        fn()
        calls += 1
        end.record()
        end.synchronize()
        if start.elapsed_time(end) >= 1e3 * min_seconds:
            return calls * steps_per_call / (start.elapsed_time(end) / 1e3)


if __name__ == "__main__":
    sys.exit(main())
