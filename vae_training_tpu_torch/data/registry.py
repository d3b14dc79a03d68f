"""Dataset registry / factory.

Port of ``vae_training_tpu/data/registry.py``. An unknown name raises with
the available choices; a reference dataset this port has not reached yet
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import DistributionDataset
from .synthetic import LinearGaussianDataset

_REGISTRY: Dict[str, Callable[..., DistributionDataset]] = {}

# reference datasets still to port → the ROADMAP item that ports them
NOT_YET_PORTED = {
    "sigmoid": "ROADMAP Queue 1 item 4 (with kernel K2)",
    "sphere": "ROADMAP Queue 1 item 4",
    "gaussian": "ROADMAP Queue 1 item 4",
    "image": "ROADMAP Queue 1 item 9 (epoch mode and the conv VAE)",
}


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def dataset_names():
    return sorted(_REGISTRY)


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


def check_dataset_name(name: str) -> None:
    if name in _REGISTRY:
        return
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"--dataset {name} is not yet ported to vae_training_tpu_torch; "
            f"see {NOT_YET_PORTED[name]}")
    raise ValueError(f"Unknown dataset {name!r}. Available: {dataset_names()}")


def get_dataset(name: str, seed: int, args, device="cpu") -> DistributionDataset:
    check_dataset_name(name)
    return _REGISTRY[name](seed, args, device=device)
