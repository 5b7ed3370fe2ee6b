"""Input pipelines (counterpart of vaw_tpu/data/datasets.py).

Datasets produce whole numpy batches, NHWC float32; ``to_device`` moves
one to the card through pinned memory with a non-blocking copy. Ported so
far: the synthetic ``Gaussian`` dataset (:139), the shuffled ``BatchLoader``
(:526) and ``load_dataset`` (:594), copied as numpy so the port imports
nothing of the JAX package. Every other dataset (CIFAR-10, Shapes, image
folders, the latent HDF5 sets and their slab loader) raises, naming
ROADMAP A7.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator

import numpy as np
import torch

__all__ = ["GaussianDataset", "BatchLoader", "load_dataset", "to_device"]


class GaussianDataset:
    """Synthetic standard-normal data (the reference's 'Gaussian' dataset
    choice, main.py:43), for smoke tests and throughput runs."""

    def __init__(self, image_size=32, channels=3, num_classes=0,
                 length=50_000, seed=0):
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        # A pure function of the index, not of call order: sample i is the
        # same array in every epoch and in a resumed run.
        per = self.image_size * self.image_size * self.channels
        imgs = np.empty((len(idx), per), np.float32)
        labels = np.empty((len(idx),), np.int32)
        for j, i in enumerate(np.asarray(idx)):
            rs = np.random.RandomState(
                (self.seed * 1_000_003 + int(i)) & 0x7FFFFFFF)
            imgs[j] = rs.randn(per).astype(np.float32)
            labels[j] = rs.randint(0, max(self.num_classes, 1))
        out = {"image": imgs.reshape(len(idx), self.image_size,
                                     self.image_size, self.channels)}
        if self.num_classes > 0:
            out["label"] = labels
        return out


class BatchLoader:
    """Shuffled epoch iterator producing whole batches (replacing the
    reference's DataLoader, main.py:166-180). The multi-process sharding
    of the JAX loader comes with the parallel layouts (ROADMAP A16)."""

    def __init__(self, dataset, batch_size: int, shuffle=True, seed=0,
                 drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self._skip = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def fast_forward(self, n_batches: int):
        """Resume: advance the epoch counter and the within-epoch batch
        offset to where an uninterrupted run would be after `n_batches`
        more batches."""
        per = len(self)
        if per <= 0:
            return
        self.epoch += n_batches // per
        self._skip = n_batches % per

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        skip, self._skip = self._skip, 0
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        end = n - n % self.batch_size if self.drop_last else n
        for i in range(skip * self.batch_size, end, self.batch_size):
            yield self.dataset.get_batch(idx[i: i + self.batch_size])

    def forever(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield from iter(self)


def load_dataset(data_dir: str, dataset: str, batch_size: int,
                 image_size: int, num_workers: int = 0, shuffle: bool = True,
                 seed: int = 0, num_classes: int = 0, channels: int = 3):
    """(train_loader, test_loader) for `dataset` (reference:
    datasets/data_loader.py:199-224). Only 'Gaussian' is ported."""
    del data_dir, num_workers  # used by the datasets still to port
    if dataset != "Gaussian":
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported to vaw_torch yet: ROADMAP A7 "
            "(only Gaussian is served)")
    train = GaussianDataset(image_size=image_size, channels=channels,
                            num_classes=num_classes)
    test = GaussianDataset(image_size=image_size, channels=channels,
                           num_classes=num_classes, length=10_000, seed=1)
    return (BatchLoader(train, batch_size, shuffle=shuffle, seed=seed),
            BatchLoader(test, batch_size, shuffle=False, seed=seed))


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch on `device`: images f32, labels int64. On a CUDA
    device each array goes through pinned memory and a non-blocking copy,
    so the host does not wait for the card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k == "label":
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
