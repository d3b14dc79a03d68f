from .base import DistributionDataset, pad_with_zeros, padding_energy
from .images import ImageDataset
from .registry import dataset_names, get_dataset, register_dataset
from .synthetic import GaussianDataset, LinearGaussianDataset, SigmoidDataset, SphereDataset

__all__ = [
    "DistributionDataset", "GaussianDataset", "LinearGaussianDataset", "dataset_names",
    "get_dataset", "ImageDataset", "pad_with_zeros", "padding_energy", "register_dataset",
    "SigmoidDataset", "SphereDataset",
]
