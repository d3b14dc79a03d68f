from .base import DistributionDataset, pad_with_zeros, padding_energy
from .registry import dataset_names, get_dataset, register_dataset
from .synthetic import LinearGaussianDataset

__all__ = [
    "DistributionDataset", "LinearGaussianDataset", "dataset_names",
    "get_dataset", "pad_with_zeros", "padding_energy", "register_dataset",
]
