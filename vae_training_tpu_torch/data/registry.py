"""Dataset registry / factory.

Port of ``vae_training_tpu/data/registry.py``. An unknown name raises with
the available choices. Every factory takes the run's device: the dataset's
tensors (an image corpus, a manifold's matrix) live there. ``get_dataset``
resolves ``--precision`` on that device (``config.bf16_dots``) and sets the
dataset's ``bf16_dots``: the manifold dots of ``linear_gaussian`` and
``sigmoid`` take bfloat16 operands on the card under ``bf16``.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import DistributionDataset
from .synthetic import GaussianDataset, LinearGaussianDataset, SigmoidDataset, SphereDataset

_REGISTRY: Dict[str, Callable[..., DistributionDataset]] = {}


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def dataset_names():
    return sorted(_REGISTRY)


@register_dataset("gaussian")
def _make_gaussian(seed, args, device="cpu") -> GaussianDataset:
    # --dataset_noise is the padding's variance; the core takes no seed
    return GaussianDataset(dim=args.dataset_dimension, padding_dim=args.padding_dim,
                           noise_level=args.dataset_noise, device=device)


@register_dataset("linear_gaussian")
def _make_linear_gaussian(seed, args, device="cpu") -> LinearGaussianDataset:
    return LinearGaussianDataset.create(
        seed,
        dimension=args.dataset_dimension,
        intrinsic_dimension=args.dataset_intrinsic_dimension,
        padding_dimension=args.padding_dim,
        var_added=args.dataset_noise,
        device=device,
    )


@register_dataset("sigmoid")
def _make_sigmoid(seed, args, device="cpu") -> SigmoidDataset:
    return SigmoidDataset.create(
        seed,
        dimension=args.dataset_dimension,
        padding_dimension=args.padding_dim,
        device=device,
    )


@register_dataset("sphere")
def _make_sphere(seed, args, device="cpu") -> SphereDataset:
    return SphereDataset(dim=args.dataset_dimension,
                         padding_dim=args.padding_dim, device=device)


@register_dataset("image")
def _make_image(seed, args, device="cpu"):
    """Epoch-mode image corpus (the conv VAE's, BASELINE.json config 5):
    synthetic digits from the seed, an .npz, or a folder of images."""
    from .images import ImageDataset

    source = args.image_source
    if source == "synthetic":
        return ImageDataset.synthetic_digits(seed, n=args.num_images, size=args.image_size,
                                             device=device)
    if source.endswith(".npz"):
        return ImageDataset.from_npz(source, pixel_range=args.image_range, device=device)
    return ImageDataset.from_folder(source, size=args.image_size, device=device)


def check_dataset_name(name: str) -> None:
    if name in _REGISTRY:
        return
    raise ValueError(f"Unknown dataset {name!r}. Available: {dataset_names()}")


def get_dataset(name: str, seed: int, args, device="cpu") -> DistributionDataset:
    from ..config import bf16_dots

    check_dataset_name(name)
    dataset = _REGISTRY[name](seed, args, device=device)
    dataset.bf16_dots = bf16_dots(getattr(args, "precision", "bf16"), device)
    return dataset
