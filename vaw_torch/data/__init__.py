"""Input pipelines: the synthetic Gaussian dataset and the batch loader."""

from .datasets import BatchLoader, GaussianDataset, load_dataset, to_device

__all__ = ["BatchLoader", "GaussianDataset", "load_dataset", "to_device"]
