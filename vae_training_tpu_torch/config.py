"""Typed run configuration + the reference's exact CLI flag surface.

Port of ``vae_training_tpu/config.py:18-294``. Every reference flag keeps
its name, default and help, so each reference invocation parses here
unchanged. What differs from the JAX package:

  - ``--device {cuda,cpu}`` (default cuda) picks the device explicitly, the
    counterpart of ``JAX_PLATFORMS``. ``--device cuda`` without a CUDA
    device raises; nothing falls back to the CPU.
  - ``--kernels auto|torch|cuda`` replaces ``auto|xla|pallas``
    (``kernels/dispatch.py``).
  - ``--precision``: both values compute true fp32 products: TF32 off on
    the torch path and in the plain versions, and fp32 FMA chains in the
    kernels (the MLP kernel's in the order of an fp32 GEMM's thread; a
    3xTF32 tensor-core split was measured and parted the fp32 trajectory
    past the kernels' tolerances, PERF.md). The reference's bf16-operand
    meaning (its default) is still to come, on every kernel and path
    together (ROADMAP).
  - ``-ws`` runs the analytic warm start (``models/warm_start.py``), solo
    and in a seed grid; ``-wsl`` parses and does nothing, as in the JAX
    package (nothing there reads it); ``--track_correlation`` records the
    correlation ratios (``train/loop.py``, ``utils/trees.py``).
  - Flags whose machinery is not ported yet (``--mesh``, ``--multihost``,
    ``--ckpt_backend orbax``, ``--arch conv``) raise
    ``NotImplementedError`` naming the ROADMAP item that ports them
    (``validate``).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class RunConfig:
    # --- reference flag surface ------------------------------------------
    name: str = "run"
    num_batches: int = 15000
    num_epochs: int = 10000
    batch_size: int = 100
    learning_rate: float = 1e-4
    padding_dim: int = 0
    overwrite: bool = False
    dataset: str = "4gaussian"  # reference default; errors with a clear message
    layer_sizes: str = "512|512"
    encoder_layer_sizes: str = "512|512"
    latent_dimension: int = 100
    nojit: bool = False
    padding_type: str = "none"
    dataset_seed: int = 69
    state_dict: Optional[str] = None
    data_fn: Optional[str] = None
    warm_start: bool = False
    initialize_inverse: bool = False
    use_fred_covariance: bool = False
    epsilon: float = 0.0
    tunable_decoder_var: bool = False
    dataset_noise: float = 0.0
    dataset_dimension: int = 3
    warm_start_linear: bool = False
    dataset_intrinsic_dimension: int = 3
    latent_off_dimension: int = 1
    # post-parse hardcoded fields (the reference's run.py:40-42)
    model: str = "VAE"
    latent_distribution: str = "gaussian"
    tqdm: bool = True

    # --- framework flags ----------------------------------------------------
    mesh: str = ""
    mesh_allow_uneven: bool = False
    tp_allow_replicated: bool = False
    kernels: str = "auto"  # auto | torch | cuda
    model_seed: int = 0
    resume: Optional[str] = None
    profile: bool = False
    debug_nans: bool = False
    data_dir: str = "data"
    checkpoint_every: int = 0
    seed_grid: str = ""
    arch: str = "auto"
    conv_channels: str = "32|64"
    image_source: str = "synthetic"
    image_range: str = "auto"
    image_size: int = 28
    num_images: int = 4096
    track_correlation: bool = False
    multihost: bool = False
    n_print: int = 5000
    n_plot: int = 50000
    ckpt_backend: str = "msgpack"
    # Both values compute in true fp32 (TF32 off) in this slice.
    precision: str = "bf16"
    adam_dtype: str = "f32"
    # --- port flags ---------------------------------------------------------
    device: str = "cuda"  # cuda | cpu

    @property
    def latent_dim(self) -> int:
        return self.latent_dimension

    def grid_seeds(self) -> list:
        """``--seed_grid 2,3,4`` → [2, 3, 4] (empty without the flag)."""
        try:
            return [int(s) for s in self.seed_grid.split(",") if s.strip()]
        except ValueError:
            raise ValueError(f"--seed_grid expects comma-separated integers, "
                             f"got {self.seed_grid!r}") from None

    def validate(self) -> "RunConfig":
        from .data.registry import check_dataset_name

        check_dataset_name(self.dataset)
        if self.kernels not in ("auto", "torch", "cuda"):
            raise ValueError(f"--kernels must be auto|torch|cuda, got {self.kernels}")
        if self.arch not in ("auto", "mlp", "conv"):
            raise ValueError(f"--arch must be auto|mlp|conv, got {self.arch}")
        if self.ckpt_backend not in ("msgpack", "orbax"):
            raise ValueError(
                f"--ckpt_backend must be msgpack|orbax, got {self.ckpt_backend}")
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"--precision must be fp32|bf16, got {self.precision}")
        if self.adam_dtype not in ("f32", "bf16"):
            raise ValueError(f"--adam_dtype must be f32|bf16, got {self.adam_dtype}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"--device must be cuda|cpu, got {self.device}")
        not_ported = {
            "--mesh": (bool(self.mesh), "ROADMAP Queue 1 item 11 (parallel)"),
            "--multihost": (self.multihost, "ROADMAP Queue 1 item 11 (parallel)"),
            "--ckpt_backend orbax": (self.ckpt_backend == "orbax",
                                     "ROADMAP Queue 1 item 12 (orbax is left out)"),
            "--arch conv": (self.arch == "conv",
                            "ROADMAP Queue 1 item 9 (epoch mode and the conv VAE)"),
        }
        if self.seed_grid and not self.grid_seeds():
            raise ValueError(f"--seed_grid names no seed: {self.seed_grid!r}")
        for flag, (used, item) in not_ported.items():
            if used:
                raise NotImplementedError(
                    f"{flag} is not yet ported to vae_training_tpu_torch; see {item}")
        if self.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "--device cuda but no CUDA device is available "
                    "(pass --device cpu to run on the CPU)")
        return self

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="VAE training on PyTorch/CUDA (reference-compatible CLI)")
    # Reference flags — names, defaults, and help mirror the reference run.py.
    p.add_argument("name", help="The name of the experiment and output directory.")
    p.add_argument("--num_batches", dest="num_batches", type=int, default=15000,
                   help="Number of batches to train on.")
    p.add_argument("--num_epochs", dest="num_epochs", type=int, default=10000)
    p.add_argument("--batch_size", dest="batch_size", type=int, default=100)
    p.add_argument("-lr", "--learning_rate", dest="learning_rate", type=float,
                   default=0.0001)
    p.add_argument("--padding_dim", type=int, dest="padding_dim", default=0)
    p.add_argument("-ow", dest="overwrite", action="store_true")
    p.add_argument("--dataset", dest="dataset", default="4gaussian",
                   choices=["sphere", "linear_gaussian", "sigmoid", "gaussian",
                            "image"])
    p.add_argument("--layer_sizes", dest="layer_sizes", default="512|512",
                   help="Decoder MLP layer sizes as pipe-separated ints, e.g. 512|512; "
                        "empty string = pure linear decoder.")
    p.add_argument("--encoder_layer_sizes", dest="encoder_layer_sizes",
                   default="512|512",
                   help="Encoder MLP layer sizes as pipe-separated ints; "
                        "empty string = pure linear encoder.")
    p.add_argument("--latent_dim", dest="latent_dimension", type=int, default=100)
    p.add_argument("-nojit", dest="nojit", action="store_true",
                   help="Step-through debugging: PyTorch runs eagerly, so this "
                        "selects the plain torch path (no fused kernel).")
    p.add_argument("--padding_type", dest="padding_type", default="none",
                   choices=["zero", "gaussian", "none"])
    p.add_argument("-ds", "--dataset_seed", dest="dataset_seed", type=int, default=69)
    p.add_argument("--state_dict", dest="state_dict", default=None)
    p.add_argument("--data_fn", dest="data_fn", default=None)
    p.add_argument("-ws", "--warm_start", action="store_true")
    p.add_argument("-ii", "--initialize_inverse", action="store_true")
    p.add_argument("-ufc", "--use_fred_covariance", action="store_true")
    p.add_argument("-e", "--epsilon", type=float, default=0.0)
    p.add_argument("-tdv", dest="tunable_decoder_var", action="store_true")
    p.add_argument("-dn", "--dataset_noise", type=float, default=0.0)
    p.add_argument("-dd", "--dataset_dimension", type=int, default=3)
    p.add_argument("-wsl", "--warm_start_linear", action="store_true")
    p.add_argument("-did", "--dataset_intrinsic_dimension", type=int, default=3)
    p.add_argument("-off", "--latent_off_dimension", type=int, default=1)
    # Framework flags (kept from the JAX package; unported ones raise).
    p.add_argument("--mesh", dest="mesh", default="",
                   help="Device mesh spec (not yet ported).")
    p.add_argument("--mesh_allow_uneven", dest="mesh_allow_uneven",
                   action="store_true")
    p.add_argument("--tp_allow_replicated", dest="tp_allow_replicated",
                   action="store_true")
    p.add_argument("--kernels", dest="kernels", default="auto",
                   choices=["auto", "torch", "cuda"],
                   help="Compute backend for training chunks: auto = the fused "
                        "CUDA kernel where it can run, else the torch path; "
                        "cuda = the kernel or an error; torch = plain PyTorch.")
    p.add_argument("--model_seed", dest="model_seed", type=int, default=0)
    p.add_argument("--resume", dest="resume", default=None,
                   help="Checkpoint directory to resume training from. With "
                        "--seed_grid, any non-empty value resumes every row "
                        "from its own <name>_seed<N>/ checkpoint.")
    p.add_argument("--profile", dest="profile", action="store_true",
                   help="Capture a torch.profiler trace of one training chunk "
                        "(<run>/profile/trace.json).")
    p.add_argument("--debug_nans", dest="debug_nans", action="store_true",
                   help="Raise FloatingPointError at the first non-finite loss or "
                        "parameter (the torch path also under "
                        "torch.autograd.detect_anomaly).")
    p.add_argument("--data_dir", dest="data_dir", default="data")
    p.add_argument("--checkpoint_every", dest="checkpoint_every", type=int, default=0)
    p.add_argument("--seed_grid", dest="seed_grid", default="",
                   help="Comma-separated dataset seeds, e.g. '2,3,4': trains "
                        "every seed together, one kernel launch a chunk; "
                        "outputs land in <name>_seed<N>/.")
    p.add_argument("--arch", dest="arch", default="auto",
                   choices=["auto", "mlp", "conv"])
    p.add_argument("--conv_channels", dest="conv_channels", default="32|64")
    p.add_argument("--image_source", dest="image_source", default="synthetic")
    p.add_argument("--image_range", dest="image_range", default="auto",
                   choices=["auto", "0_255", "0_1", "pm1"])
    p.add_argument("--image_size", dest="image_size", type=int, default=28)
    p.add_argument("--num_images", dest="num_images", type=int, default=4096)
    p.add_argument("--track_correlation", dest="track_correlation",
                   action="store_true")
    p.add_argument("--multihost", dest="multihost", action="store_true")
    p.add_argument("--n_print", dest="n_print", type=int, default=5000,
                   help="Stat cadence in steps (reference: 5000).")
    p.add_argument("--n_plot", dest="n_plot", type=int, default=50000,
                   help="Plot/save cadence in steps (reference: 50000).")
    p.add_argument("--ckpt_backend", dest="ckpt_backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="Checkpoint format; msgpack selects the port's "
                        "torch.save checkpoint.")
    p.add_argument("--precision", dest="precision", default="bf16",
                   choices=["bf16", "fp32"],
                   help="Matmul precision. In this port both values compute "
                        "true fp32 products (TF32 off on the torch path, fp32 "
                        "FMA chains in the kernels); the reference's "
                        "bf16-operand meaning is still to come.")
    p.add_argument("--adam_dtype", dest="adam_dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="Adam moment storage: bf16 stores the moments of every "
                        "weight matrix in bfloat16 (computed in f32, rounded to "
                        "nearest even every step); biases keep f32 moments. "
                        "Must match across --resume.")
    p.add_argument("--device", dest="device", default="cuda",
                   choices=["cuda", "cpu"],
                   help="Device to train on. cuda without a CUDA device is "
                        "an error, never a silent CPU run.")
    return p


def parse_arguments(argv=None) -> RunConfig:
    args = build_parser().parse_args(argv)
    cfg = RunConfig(**vars(args))
    # Post-parse hardcoded fields, mirroring the reference's run.py:40-42.
    cfg.model = "VAE"
    cfg.latent_distribution = "gaussian"
    cfg.tqdm = True
    return cfg
