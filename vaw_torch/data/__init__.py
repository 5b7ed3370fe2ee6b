"""Input pipelines: the datasets, the batch and slab loaders, and the
prefetcher to the card."""

from .datasets import (
    BatchLoader,
    Cifar10Dataset,
    GaussianDataset,
    ImageFolderDataset,
    LatentDataset,
    LatentWithPixelDataset,
    ShapesDataset,
    SlabShuffleLoader,
    center_crop_arr,
    load_dataset,
    random_crop_arr,
    to_device,
)
from .pipeline import prefetch_to_device

__all__ = [
    "BatchLoader", "Cifar10Dataset", "GaussianDataset", "ImageFolderDataset",
    "LatentDataset", "LatentWithPixelDataset", "ShapesDataset",
    "SlabShuffleLoader", "center_crop_arr", "random_crop_arr", "load_dataset",
    "prefetch_to_device", "to_device",
]
