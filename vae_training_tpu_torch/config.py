"""Typed run configuration + the reference's exact CLI flag surface.

Port of ``vae_training_tpu/config.py:18-294``. Every reference flag keeps
its name, default and help, so each reference invocation parses here
unchanged. What differs from the JAX package:

  - ``--device {cuda,cpu}`` (default cuda) picks the device explicitly, the
    counterpart of ``JAX_PLATFORMS``. ``--device cuda`` without a CUDA
    device raises; nothing falls back to the CPU.
  - ``--kernels auto|torch|cuda`` replaces ``auto|xla|pallas``
    (``kernels/dispatch.py``).
  - ``--precision`` (``bf16_dots``): on the card, ``bf16`` (the default)
    is the reference's accelerator mode: every dot the JAX package runs at
    ``precision=None`` (the Dense and conv layers' products and both their
    gradient products, the kernels' forward, analytic backward and manifold
    draws, the samplers' and the sigmoid score's manifold dots) takes its
    operands rounded to bfloat16, round to nearest even, and sums the exact
    products in f32; biases, bias gradients, masks, the ELBO, Adam and the
    master weights stay f32 (``ops/precision.py``, the kernels' bf16-dot
    instantiations). ``fp32`` computes true fp32 products. On the CPU both
    values compute true fp32 products, bitwise alike, as XLA's CPU backend
    does for the JAX package: this is the reference's own CPU semantics, not
    a fallback. On the card a kernel that cannot run the bf16 mode raises;
    nothing computes fp32 in its place. TF32 is off in both modes
    (``use_fp32_math``, which every entry point calls on the card): a bf16
    dot is an fp32 GEMM on rounded operands.
  - ``-ws`` runs the analytic warm start (``models/warm_start.py``), solo
    and in a seed grid; ``-wsl`` parses and does nothing, as in the JAX
    package (nothing there reads it); ``--track_correlation`` records the
    correlation ratios (``train/loop.py``, ``utils/trees.py``).
  - ``--mesh`` shards training over the ranks of a ``torch.distributed``
    run, one process a device (``parallel/``); ``--multihost`` (or
    ``WORLD_SIZE`` > 1) starts the process group (``utils/process.py``).
  - ``--ckpt_backend orbax`` writes a ``torch.distributed.checkpoint``
    (DCP) directory, the PyTorch world's counterpart of orbax's
    (``runio/checkpoint.py``); ``msgpack``, the default, the ``torch.save``
    trio. As in the JAX package, ``orbax`` with ``--multihost`` raises
    (``validate``), and so does ``orbax`` with ``--seed_grid``
    (``train/grid.py``).
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
    # bf16: bfloat16 dot operands with f32 sums on the card (bf16_dots)
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
        if self.seed_grid and not self.grid_seeds():
            raise ValueError(f"--seed_grid names no seed: {self.seed_grid!r}")
        if self.mesh:
            from .parallel.mesh import parse_mesh_spec

            parse_mesh_spec(self.mesh)  # a bad spec fails before any handshake
        if self.ckpt_backend == "orbax" and self.multihost:
            # the JAX CLI's refusal (its config.py:136-149) and its reason,
            # kept so that a flag set one CLI takes the other takes too (the
            # port's DCP save itself runs with no_dist, on process 0 alone)
            raise ValueError(
                "--ckpt_backend orbax does not compose with --multihost, as on the "
                "JAX CLI: orbax saves are collective across processes while this "
                "engine's artifact writes are process-0-only (a primary-gated orbax "
                "save deadlocks in its cross-process barrier). Use the default "
                "msgpack backend for multihost runs.")
        if self.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "--device cuda but no CUDA device is available "
                    "(pass --device cpu to run on the CPU)")
        return self

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def bf16_dots(precision: str, device) -> bool:
    """The dot mode ``--precision`` resolves to on ``device``: True (bf16
    operands, f32 sums) for ``bf16`` on a CUDA device; False (true fp32
    products) for ``fp32``, and for either value on the CPU, where the JAX
    package's XLA backend computes f32 dots exactly under every precision
    (the counterpart of its ``fp32_dots``, negated). Every entry point
    resolves the flag here once and hands the bool to the model, the
    dataset and the kernels."""
    import torch

    if precision not in ("bf16", "fp32"):
        raise ValueError(f"--precision must be fp32|bf16, got {precision}")
    return precision == "bf16" and torch.device(device).type == "cuda"


def use_fp32_math(device) -> None:
    """The card's float32 contract (``--precision``), set once by every
    entry point: no TF32 in cuBLAS or cuDNN, and cuDNN deterministic with
    its autotuner off, so a convolution's algorithm (and its bits) is the
    same in every run, op by op and under a CUDA graph. Nothing to set on
    the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


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
                   help="Device mesh over the run's ranks, e.g. 'dp=8', 'dp=4,tp=2' "
                        "or 'dp_dcn=2,dp=4' (one process a device; torchrun).")
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
    p.add_argument("--multihost", dest="multihost", action="store_true",
                   help="Start the torch.distributed process group from torchrun's "
                        "environment (also when WORLD_SIZE > 1 without it).")
    p.add_argument("--n_print", dest="n_print", type=int, default=5000,
                   help="Stat cadence in steps (reference: 5000).")
    p.add_argument("--n_plot", dest="n_plot", type=int, default=50000,
                   help="Plot/save cadence in steps (reference: 50000).")
    p.add_argument("--ckpt_backend", dest="ckpt_backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="Checkpoint format: msgpack selects the port's torch.save "
                        "checkpoint; orbax a torch.distributed.checkpoint (DCP) "
                        "directory, the PyTorch counterpart of orbax's.")
    p.add_argument("--precision", dest="precision", default="bf16",
                   choices=["bf16", "fp32"],
                   help="Matmul precision. bf16 (default): on the card every "
                        "layer, gradient, sampler and kernel dot rounds its "
                        "operands to bfloat16 and sums in f32, as the "
                        "reference's accelerator does; fp32: true fp32 products. "
                        "On the CPU both compute true fp32 products, as the "
                        "reference does on its CPU.")
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
