#!/usr/bin/env python
"""Headline benchmark of the port: training steps/s on one GPU, one JSON line
on stdout.

    python -m vae_training_tpu_torch._scripts.bench [--config linear] \
        [--kernels auto|torch|cuda] [--adam_dtype f32|bf16] [--device cuda|cpu] \
        [--latency] [--min STEPS_PER_SEC]

(console script ``vae-bench-torch``). Port of
``vae_training_tpu/_scripts/bench.py``. The workloads are the JAX bench's
(``CONFIGS``, ``CONFIG_SEEDS``): row 1 of the linear, sigmoid and sphere
sweeps, each on one trainer (``linear``, ``sigmoid``, ``sphere``), and each
whole sweep family as one grid (``grid_linear`` 21 rows, ``grid_sigmoid``
18, ``grid_sphere`` 15; their value is the AGGREGATE of row-steps/s). The
line is

    {"metric": ..., "value": steps/s, "unit": "steps/sec",
     "flops_per_step": ..., "mfu_pct": ..., "device": ..., "power_limit_w": ...}

``value`` is the median of at least five windows of at least 1 s of device
time each, timed with CUDA events, each chunk waited for before the next
(the min, max and count go to stderr with every other diagnostic).
``flops_per_step`` counts the matmul terms exactly as the JAX bench does
(``mlp_step_flops``), and ``mfu_pct`` quotes them against the card's dense
bf16 tensor-core peak, by device name; stderr also gives the share of the
fp32 peak, which is what the kernels' fp32 FMA chains can reach. ``device``
and ``power_limit_w`` are what ``nvidia-smi`` reads.

``--config conv`` is the JAX bench's ``build_conv`` (BASELINE.json config
5): the conv VAE (32|64, latent 16) on 4096 synthetic 28×28 images, batch
128, lr 1e-3, ε −1, -tdv; its value is minibatch steps/s of whole epochs
(32 steps a chunk, each epoch's own permutation), windows as above.

Left out of the JAX bench: its ``vs_baseline`` ratio (the 20,000 steps/s of
``BASELINE.json`` is a target set for the TPU, not for this card); its
supervisor (``--no-supervise``, a workaround for a TPU runtime's hanging
init); its retry of a failed solo backend on another (a kernel that fails
raises here). The grid configs fall back, under ``--kernels auto`` only, to one
grid launch a group when the sweep cannot share one launch, and say so;
``--kernels torch`` measures the groups that way on purpose (the
comparison column). ``--device cuda`` (the default) needs a card; on
``--device cpu`` the rate is a host measurement, named ``..._on_cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Tuple

import torch

from vae_training_tpu_torch.config import RunConfig, use_fp32_math


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# Sweep-representative configs (flags exactly as the reference's scripts
# set them): linear row 1, sigmoid row 1, sphere row 1.
CONFIGS = {
    "linear": dict(
        dataset="linear_gaussian", encoder_layer_sizes="", layer_sizes="",
        latent_dimension=20, padding_dim=9, dataset_dimension=3,
        dataset_intrinsic_dimension=3, learning_rate=1e-3, epsilon=-1.0,
    ),
    "sigmoid": dict(
        dataset="sigmoid", encoder_layer_sizes="", layer_sizes="",
        latent_dimension=6, padding_dim=3, dataset_dimension=3,
        learning_rate=1e-4, epsilon=-3.0,
    ),
    "sphere": dict(
        dataset="sphere", encoder_layer_sizes="200|200|200",
        layer_sizes="200|200|200", latent_dimension=6, padding_dim=3,
        dataset_dimension=3, learning_rate=1e-4, epsilon=-3.0,
    ),
}

# Row-1 dataset seeds as the scripts pass them: the linear script's first
# run uses -ds 2, the sigmoid and sphere scripts' first runs pass none (the
# reference default, 69).
CONFIG_SEEDS = {"linear": 2, "sigmoid": 69, "sphere": 69}

# one sweep family a grid config ("grid" is the JAX bench's alias)
GRID_FAMILIES = {"grid": "linear", "grid_linear": "linear",
                 "grid_sigmoid": "sigmoid", "grid_sphere": "sphere"}

METRIC_NAMES = {
    "linear": "linear_vae_train_steps_per_sec",
    "sigmoid": "sigmoid_vae_train_steps_per_sec",
    "sphere": "sphere_mlp200_vae_train_steps_per_sec",
    "grid": "linear_sweep21_aggregate_steps_per_sec",
    "grid_linear": "linear_sweep21_aggregate_steps_per_sec",
    "grid_sigmoid": "sigmoid_sweep18_aggregate_steps_per_sec",
    "grid_sphere": "sphere_sweep15_aggregate_steps_per_sec",
    "conv": "conv_vae_train_steps_per_sec",
}

# steps a timed chunk: a few to a few hundred ms of the card each, so that a
# window of >= 1 s holds several chunks and their fixed cost is small
CHUNK_STEPS = {"linear": 20_000, "sigmoid": 20_000, "sphere": 2_000,
               "grid": 5_000, "grid_linear": 5_000, "grid_sigmoid": 5_000,
               "grid_sphere": 1_000}

# (fragment of torch.cuda.get_device_name, dense bf16 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores): NVIDIA's H100 data sheet, without
# sparsity, at each part's full power limit
PEAKS = (("H100 NVL", 835e12, 60e12), ("H100 PCIe", 756e12, 51e12),
         ("H100 80GB HBM3", 989.4e12, 67e12), ("H100 SXM", 989.4e12, 67e12))


def make_cfg(config: str, kernels: str = "auto", precision: str = "bf16",
             adam_dtype: str = "f32", device: str = "cuda") -> RunConfig:
    return RunConfig(
        name="bench",
        num_batches=100_000,
        batch_size=100,
        tunable_decoder_var=True,
        dataset_seed=CONFIG_SEEDS[config],
        tqdm=False,
        kernels=kernels,
        precision=precision,
        adam_dtype=adam_dtype,
        device=device,
        **CONFIGS[config],
    ).validate()


def build(kernels: str = "auto", config: str = "linear", precision: str = "bf16",
          adam_dtype: str = "f32", device: str = "cuda"):
    """A solo Trainer of one config (no output is written)."""
    from vae_training_tpu_torch.data import get_dataset
    from vae_training_tpu_torch.train.loop import Trainer

    cfg = make_cfg(config, kernels, precision, adam_dtype, device)
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg, device=torch.device(device))
    return Trainer(cfg, dataset, output_dir=".")


def build_conv(kernels: str = "auto", precision: str = "bf16", adam_dtype: str = "f32",
               device: str = "cuda"):
    """The conv VAE's epoch-mode Trainer (the JAX bench's ``build_conv``:
    4096 synthetic 28×28 images from seed 0, conv stack 32|64, latent 16,
    batch 128, lr 1e-3, ε −1, -tdv; no output is written)."""
    from vae_training_tpu_torch.data import get_dataset
    from vae_training_tpu_torch.train.loop import Trainer

    cfg = RunConfig(
        name="bench_conv", dataset="image", image_source="synthetic", image_size=28,
        num_images=4096, num_epochs=10, batch_size=128, latent_dimension=16,
        conv_channels="32|64", learning_rate=1e-3, epsilon=-1.0, tunable_decoder_var=True,
        tqdm=False, kernels=kernels, precision=precision, adam_dtype=adam_dtype,
        device=device).validate()
    dataset = get_dataset(cfg.dataset, 0, cfg, device=torch.device(device))
    return Trainer(cfg, dataset, output_dir=".")


class _PerGroupSweep:
    """``MixedGridSweep``'s timing surface (``groups``, ``n_rows``,
    ``_chunk``) over one grid launch a group."""

    def __init__(self, groups):
        from vae_training_tpu_torch.kernels.dispatch import make_grid_chunk

        self.groups = groups
        self.n_rows = sum(len(g.seeds) for g in groups)
        self._chunks = [make_grid_chunk([g.model] * len(g.seeds), g.datasets, g.cfg)
                        for g in groups]

    def _chunk(self, states, n_steps):
        out, losses, off = [], [], 0
        for g, chunk in zip(self.groups, self._chunks):
            k = len(g.seeds)
            new, lg = chunk(states[off:off + k], n_steps)
            out += new
            losses.append(lg)
            off += k
        return out, torch.cat(losses)


def build_grid(kernels: str = "auto", precision: str = "bf16", family: str = "linear",
               adam_dtype: str = "f32", device: str = "cuda"):
    """A whole sweep family as one grid: every (dd, pd, ld) row × every
    seed of the reference sweep (linear 21 rows, sigmoid 18, sphere 15),
    trained by ``MixedGridSweep`` in one launch a chunk."""
    from vae_training_tpu_torch._scripts import sweep as sweep_mod
    from vae_training_tpu_torch.train.grid import GridTrainer
    from vae_training_tpu_torch.train.mixed_grid import MixedGridSweep, MixedSweepUnavailable

    seeds = sweep_mod.SWEEP_SEEDS[family]
    rows = {}
    for cfg in sweep_mod.sweep_configs(family, "data", None, kernels, adam_dtype, device):
        cfg.precision = precision
        key = (cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension)
        rows.setdefault(key, {})[cfg.dataset_seed] = cfg
    groups = [GridTrainer(by_seed[seeds[0]], seeds, build_chunk=False)
              for by_seed in rows.values()]
    if kernels == "torch":
        # the comparison column: the same rows, one torch-path grid a group
        return _PerGroupSweep(groups)
    try:
        return MixedGridSweep(groups)
    except MixedSweepUnavailable as e:
        if kernels == "cuda":
            raise  # a requested backend is never papered over
        log(f"one-launch unavailable ({e}); one grid launch a group")
        return _PerGroupSweep(groups)


def _timer(device: torch.device) -> Callable[[], Callable[[], float]]:
    """→ ``mark``: ``mark()`` starts a clock and returns ``elapsed()``, the
    seconds since, read once the work queued so far has finished (CUDA
    events on a card, the host clock on the CPU)."""
    if device.type == "cuda":
        def mark():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            end = torch.cuda.Event(enable_timing=True)

            def elapsed():
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            return elapsed
    else:
        def mark():
            t0 = time.perf_counter()
            return lambda: time.perf_counter() - t0
    return mark


def windows(call: Callable[[], None], steps_per_call: float, device: torch.device,
            n_windows: int = 5, min_seconds: float = 1.0) -> Tuple[List[float], int]:
    """(steps/s in each of ``n_windows`` windows of at least
    ``min_seconds``, the number of calls made): ``call`` repeated, each call
    waited for before the next (so the queue never runs ahead of the
    window), after one warm-up call."""
    mark = _timer(device)
    call()
    mark()()
    rates, total = [], 1
    for _ in range(n_windows):
        elapsed, calls = mark(), 0
        while True:
            call()
            calls += 1
            secs = elapsed()
            if secs >= min_seconds:
                rates.append(calls * steps_per_call / secs)
                break
        total += calls
    return rates, total


def measure(trainer, chunk_steps: int = 20_000, n_windows: int = 5,
            min_seconds: float = 1.0) -> Tuple[List[float], int]:
    """(steps/s a window, chunks run) of ``trainer``'s chunks, the state
    chained through."""
    box = [trainer.state]

    def call():
        box[0], _ = trainer.train_chunk(box[0], chunk_steps)

    out = windows(call, chunk_steps, trainer.device, n_windows, min_seconds)
    trainer.state = box[0]
    return out


def measure_conv(trainer, n_windows: int = 5, min_seconds: float = 1.0
                 ) -> Tuple[List[float], int]:
    """(minibatch steps/s a window, epochs run) of ``trainer``'s epoch
    chunks, one epoch a call, the epochs numbered on and the state chained
    through."""
    n_batches = trainer.dataset.n // trainer.cfg.batch_size
    box = [trainer.state, 0]

    def call():
        box[0], _ = trainer.epoch_chunk(box[0], box[1], n_batches)
        box[1] += 1

    out = windows(call, n_batches, trainer.device, n_windows, min_seconds)
    trainer.state = box[0]
    return out


def measure_grid(sweep, chunk_steps: int = 5_000, n_windows: int = 5,
                 min_seconds: float = 1.0) -> Tuple[List[float], int]:
    """(aggregate row-steps/s a window, chunks run) of a sweep's chunks."""
    box = [[s for g in sweep.groups for s in g.states]]

    def call():
        box[0], _ = sweep._chunk(box[0], chunk_steps)

    device = torch.device(sweep.groups[0].cfg.device)
    out = windows(call, sweep.n_rows * chunk_steps, device, n_windows, min_seconds)
    off = 0
    for g in sweep.groups:
        g.states = box[0][off:off + len(g.seeds)]
        off += len(g.seeds)
    return out


def latency_mode(trainer, reps: int = 200) -> None:
    """One-step chunks, each timed on the host clock to its finish:
    percentiles of the per-step latency to stderr."""
    import numpy as np

    sync = (torch.cuda.synchronize if trainer.device.type == "cuda" else lambda: None)
    state, _ = trainer.train_chunk(trainer.state, 1)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, _ = trainer.train_chunk(state, 1)
        sync()
        times.append(time.perf_counter() - t0)
    trainer.state = state
    t = np.array(times) * 1e6
    log(f"per-step latency (us, host clock to the step's finish): "
        f"p50={np.percentile(t, 50):.1f} p90={np.percentile(t, 90):.1f} "
        f"p99={np.percentile(t, 99):.1f} over {reps} one-step chunks")


# ---------------------------------------------------------------------------
# Analytic FLOPs (the JAX bench's formulas, so the work counted is the same
# whatever implements it).

def mlp_step_flops(batch: int, data_dim: int, latent_dim: int,
                   enc_features, dec_features, dual: bool) -> int:
    """Matmul FLOPs of ONE training step of the MLP VAE: a Dense forward
    (B,k)·(k,n) costs 2·B·k·n, the backward's dX and dW as much again each
    (training multiplier 3); the dual decoder runs two decoder stacks.
    Elementwise work (reparameterisation, ELBO, Adam) is not counted."""
    def net(in_dim, feats):
        fl, d = 0, in_dim
        for f in feats:
            fl += 2 * batch * d * f
            d = f
        return fl

    fwd = net(data_dim, enc_features)
    fwd += net(latent_dim, dec_features) * (2 if dual else 1)
    return 3 * fwd


def conv_step_flops(batch: int, image_hwc, latent_dim: int, channels) -> int:
    """Matmul FLOPs of ONE training step of the conv VAE (3×3 stride-2
    convolutions and transposed convolutions, dense layers as in
    ``mlp_step_flops``, training ×3)."""
    h, w, c = image_hwc
    k2 = 9
    fwd = 0
    cin, hh, ww = c, h, w
    for ch in channels:
        hh, ww = hh // 2, ww // 2
        fwd += 2 * batch * hh * ww * k2 * cin * ch
        cin = ch
    fwd += 2 * batch * (hh * ww * cin) * latent_dim  # FCmu
    dec_ch = tuple(reversed(channels))
    n_up = len(dec_ch)
    h0, w0 = h // (2 ** n_up), w // (2 ** n_up)
    fwd += 2 * batch * latent_dim * (h0 * w0 * dec_ch[0])  # FCin
    cin, hh, ww = dec_ch[0], h0, w0
    for ch in dec_ch[1:]:
        fwd += 2 * batch * hh * ww * k2 * cin * ch
        cin, hh, ww = ch, hh * 2, ww * 2
    fwd += 2 * batch * hh * ww * k2 * cin * c  # UpOut
    return 3 * fwd


def workload_flops_per_step(config: str, obj) -> float:
    """FLOPs per MEASURED step: grid configs count aggregate row-steps, so
    this is the average a row-step over the family's rows."""
    if config in GRID_FAMILIES:
        total = rows = 0
        for g in obj.groups:
            m = g.model
            total += len(g.seeds) * mlp_step_flops(
                g.cfg.batch_size, g.data_dim, g.latent_dim,
                m.encoder_features, m.decoder_features, m.dual_sigmoid_decoder)
            rows += len(g.seeds)
        return total / rows
    if config == "conv":
        m = obj.model
        return conv_step_flops(obj.cfg.batch_size, m.image_hwc, m.latent_dim, m.channels)
    m = obj.model
    return mlp_step_flops(obj.cfg.batch_size, obj.dataset.dimension, m.latent_dim,
                          m.encoder_features, m.decoder_features, m.dual_sigmoid_decoder)


def peaks(name: str):
    """(bf16 peak, fp32 peak) FLOP/s of the card named ``name``, or None."""
    for frag, bf16, fp32 in PEAKS:
        if frag in name:
            return bf16, fp32
    return None


def card() -> tuple:
    """(name, power limit in W) as nvidia-smi reads them."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in line.split(",", 1))
    try:
        return name, float(limit.split()[0])
    except ValueError:
        return name, None  # "[N/A]"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="linear",
                   choices=["linear", "sigmoid", "sphere", "grid", "grid_linear",
                            "grid_sigmoid", "grid_sphere", "conv"],
                   help="Which workload to measure (grid_* = the whole sweep family "
                        "as one launch; 'grid' is an alias for grid_linear).")
    p.add_argument("--latency", action="store_true",
                   help="Also report per-step latency percentiles (stderr; solo configs).")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="Matmul precision under test: bf16 (default, the "
                        "reference's): bfloat16 dot operands with f32 sums on the "
                        "card; fp32: true fp32 products (both fp32 on the CPU).")
    p.add_argument("--kernels", default="auto", choices=["auto", "torch", "cuda"],
                   help="Backend under test: auto (a fused kernel where one can run), "
                        "torch (the plain PyTorch path), cuda (the kernel or an error).")
    p.add_argument("--adam_dtype", default="f32", choices=["f32", "bf16"],
                   help="Adam moment storage under test.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda without a CUDA device is an error, never a CPU run.")
    p.add_argument("--min", dest="min_steps", type=float, default=None,
                   help="Perf-regression floor: exit 3 if steps/s falls below it "
                        "(the JSON line is still printed).")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    use_fp32_math(device)
    trainer = None
    chunk_steps = CHUNK_STEPS.get(args.config)
    # the [kernels] lines go to stderr: stdout carries the one JSON line
    with contextlib.redirect_stdout(sys.stderr):
        if args.config == "conv":
            measured = build_conv(args.kernels, args.precision, args.adam_dtype, args.device)
            chunk_steps = measured.dataset.n // measured.cfg.batch_size
            _launch_counts(reset=True)
            rates, chunks = measure_conv(measured)
        elif args.config in GRID_FAMILIES:
            measured = build_grid(args.kernels, args.precision, GRID_FAMILIES[args.config],
                                  args.adam_dtype, args.device)
            _launch_counts(reset=True)
            rates, chunks = measure_grid(measured, chunk_steps)
        else:
            trainer = measured = build(args.kernels, args.config, args.precision,
                                       args.adam_dtype, args.device)
            _launch_counts(reset=True)
            rates, chunks = measure(trainer, chunk_steps)
        launches = _launch_counts()
    steps_per_sec = statistics.median(rates)
    log(f"steps/s: median {steps_per_sec:.1f}, min {min(rates):.1f}, max {max(rates):.1f} "
        f"over {len(rates)} windows of >= 1 s ({chunk_steps}-step chunks, each waited for)")
    log(f"[kernels] {chunks} chunks timed (warm-up included); launches: "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))

    flops_per_step = workload_flops_per_step(args.config, measured)
    achieved = steps_per_sec * flops_per_step
    if device.type == "cuda":
        name, power_limit = card()
        peak = peaks(name)
        if peak is None:
            log(f"mfu: null: no peak on record for {name!r}")
        else:
            log(f"fp32 share: {100 * achieved / peak[1]:.4f}% of {peak[1] / 1e12:.1f} "
                f"TFLOP/s (the kernels' fp32 FMA chains)")
        metric = METRIC_NAMES[args.config] + "_per_gpu"
    else:
        name, power_limit, peak = "cpu", None, None
        log("mfu: null: a CPU run has no card peak")
        metric = METRIC_NAMES[args.config] + "_on_cpu"
    mfu_pct = 100.0 * achieved / peak[0] if peak else None
    log(f"flops/step: {flops_per_step:.6g}; achieved {achieved / 1e12:.6f} TFLOP/s; "
        f"mfu {mfu_pct}% of the dense bf16 peak")
    if args.latency:
        if trainer is not None:
            latency_mode(trainer)
        else:
            log("--latency applies to the linear/sigmoid/sphere configs only; skipped")
    print(json.dumps({"metric": metric, "value": steps_per_sec, "unit": "steps/sec",
                      "flops_per_step": round(flops_per_step), "mfu_pct": mfu_pct,
                      "device": name, "power_limit_w": power_limit}), flush=True)
    if args.min_steps is not None and steps_per_sec < args.min_steps:
        log(f"PERF REGRESSION: {steps_per_sec:.1f} steps/s is below the --min "
            f"{args.min_steps:.1f} floor")
        return 3
    return 0


def _launch_counts(reset: bool = False) -> dict:
    """The wrappers' launch counters (and the plain paths' chunk counts);
    ``reset`` sets them to 0 first."""
    from vae_training_tpu_torch.kernels import linear_vae, mlp_vae
    from vae_training_tpu_torch.train import step as torch_step

    counters = {"K1/K2": (linear_vae.run_fused_chunk, "launches"),
                "K6a": (linear_vae.run_grid_chunk, "launches"),
                "K5": (mlp_vae.run_mlp_fused_chunk, "launches"),
                "K6b": (mlp_vae.run_grid_chunk, "launches"),
                "plain K6a": (linear_vae.plain_grid_chunk, "calls"),
                "plain K6b": (mlp_vae.plain_grid_chunk, "calls"),
                "torch path": (torch_step.train_chunk, "calls"),
                "torch graph": (torch_step.GraphChunk, "calls")}
    if reset:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


if __name__ == "__main__":
    sys.exit(main())
