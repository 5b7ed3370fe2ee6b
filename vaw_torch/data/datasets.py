"""Input pipelines (counterpart of vaw_tpu/data/datasets.py): CIFAR-10,
synthetic Gaussian, procedural Shapes, image folders (CelebA/ImageNet/LSUN)
and the latent HDF5 datasets, with the shuffled batch loader and the slab
loader.

Datasets produce whole numpy batches, NHWC float32 in [-1, 1] (latents as
stored), from index arrays; the loaders produce them in epoch-seeded order.
``prefetch_to_device`` (data/pipeline.py) moves them to the card on a
background thread, and ``to_device`` moves one batch on the calling thread.
The code is the JAX package's, copied as numpy so the port imports nothing
of it: the same seed and indices give bit-equal batches. h5py and Pillow
are imported where a dataset needs them, so the package imports without
them. CIFAR-10 assembles its batches through the native gather
(vaw_torch.runtime), which raises rather than fall back when it cannot be
built.
"""

from __future__ import annotations

import math
import os
import pickle
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "center_crop_arr",
    "random_crop_arr",
    "Cifar10Dataset",
    "GaussianDataset",
    "ShapesDataset",
    "ImageFolderDataset",
    "LatentDataset",
    "LatentWithPixelDataset",
    "load_dataset",
    "BatchLoader",
    "SlabShuffleLoader",
    "to_device",
]


# ------------------------------------------------------------------- #
# ADM-faithful crops (reference: datasets/data_loader.py:16-59)
# ------------------------------------------------------------------- #


def center_crop_arr(pil_image, image_size: int):
    from PIL import Image

    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX
        )
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC
    )
    arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y: crop_y + image_size, crop_x: crop_x + image_size]


def random_crop_arr(pil_image, image_size: int, min_crop_frac=0.8,
                    max_crop_frac=1.0):
    from PIL import Image

    min_smaller = math.ceil(image_size / max_crop_frac)
    max_smaller = math.ceil(image_size / min_crop_frac)
    smaller = random.randrange(min_smaller, max_smaller + 1)
    while min(*pil_image.size) >= 2 * smaller:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX
        )
    scale = smaller / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC
    )
    arr = np.array(pil_image)
    crop_y = random.randrange(arr.shape[0] - image_size + 1)
    crop_x = random.randrange(arr.shape[1] - image_size + 1)
    return arr[crop_y: crop_y + image_size, crop_x: crop_x + image_size]


def _normalize(u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 [-1, 1]."""
    return u8.astype(np.float32) / 127.5 - 1.0


# ------------------------------------------------------------------- #
# datasets — each exposes __len__ and get_batch(indices) -> dict
# ------------------------------------------------------------------- #


class Cifar10Dataset:
    """CIFAR-10 from the standard python pickle archive
    (cifar-10-batches-py). The reference downloads via torchvision with a
    rank-0 + barrier dance (data_loader.py:111-131); here the archive is
    expected on disk (zero-egress environments) and loaded fully into memory
    — 180 MB, trivially resident, removing all per-item IO."""

    def __init__(self, data_dir: str, train: bool = True, flip: bool = True):
        base = os.path.join(data_dir, "cifar-10-batches-py")
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"CIFAR-10 archive not found at {base}; place the standard "
                "cifar-10-batches-py directory there."
            )
        files = (
            [f"data_batch_{i}" for i in range(1, 6)] if train
            else ["test_batch"]
        )
        images, labels = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(d[b"data"])
            labels.extend(d[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = np.transpose(data, (0, 2, 3, 1)).copy()  # NHWC uint8
        self.labels = np.asarray(labels, np.int32)
        self.flip = flip and train

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        # Single fused native pass: gather + mirror + uint8->f32 normalize
        # (vaw_torch.runtime, batch_ops.cpp), in C++ threads outside the GIL.
        from ..runtime import gather_normalize

        flips = (
            (np.random.rand(len(idx)) < 0.5).astype(np.uint8)
            if self.flip else None
        )
        return {
            "image": gather_normalize(self.images, idx, flips),
            "label": self.labels[idx],
        }


class GaussianDataset:
    """Synthetic standard-normal data (the reference's 'Gaussian' dataset
    choice, main.py:43) — used for smoke tests and throughput benches."""

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
        # A pure function of index (not of call order): sample i is the
        # same array no matter which process, epoch, or resumed run reads
        # it — required for the loader fast_forward resume-determinism
        # guarantee and the multi-host disjoint-shard tests.
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


class ShapesDataset:
    """Procedural class-conditional shapes — a learnable, zero-download
    stand-in for CIFAR-10 in zero-egress environments (the reference's
    CIFAR default, main.py:43,48, assumes torchvision can download).

    10 classes = 5 shapes (disk, square, triangle, ring, cross) x 2
    palettes (warm, cool); per-index deterministic position/size/colors on
    a class-tinted gradient background, anti-aliased, in [-1, 1]. Like
    GaussianDataset, sample i is a pure function of (seed, i) — resume
    fast-forward and multi-host disjoint shards stay deterministic."""

    NUM_CLASSES = 10

    def __init__(self, image_size=32, num_classes=10, length=50_000,
                 seed=0, flip=True):
        if not 1 <= num_classes <= self.NUM_CLASSES:
            raise ValueError(f"Shapes has 1..{self.NUM_CLASSES} classes, got {num_classes}")
        self.image_size = image_size
        self.num_classes = num_classes
        self.length = length
        self.seed = seed
        self.flip = flip
        n = image_size
        self._yy, self._xx = np.mgrid[0:n, 0:n].astype(np.float32) / (n - 1)

    def __len__(self):
        return self.length

    def _params(self, i: int):
        """Per-index deterministic draw (pure function of (seed, i))."""
        rs = np.random.RandomState((self.seed * 2_000_003 + i) & 0x7FFFFFFF)
        label = int(rs.randint(0, self.num_classes))
        palette = label // 5
        cx, cy = rs.uniform(0.3, 0.7, 2)
        r = rs.uniform(0.15, 0.3)
        if palette == 0:  # warm fg / dark bg
            fg = (rs.uniform(0.7, 1.0), rs.uniform(0.2, 0.6),
                  rs.uniform(0.0, 0.3))
            bg0, bg1 = -0.8, rs.uniform(-0.6, -0.2)
        else:  # cool fg / light bg
            fg = (rs.uniform(0.0, 0.3), rs.uniform(0.3, 0.7),
                  rs.uniform(0.7, 1.0))
            bg0, bg1 = 0.2, rs.uniform(0.4, 0.8)
        flip = bool(self.flip and rs.rand() < 0.5)
        return label, cx, cy, r, fg, bg0, bg1, flip

    def get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        # Param draws stay a per-index loop (determinism contract); the
        # pixel math is vectorized over the whole batch — ~15x faster than
        # per-image rendering, enough to stay ahead of a train step
        # behind the double-buffered prefetch.
        n = self.image_size
        b = len(idx)
        labels = np.empty((b,), np.int32)
        cx = np.empty((b, 1, 1), np.float32)
        cy = np.empty_like(cx)
        r = np.empty_like(cx)
        fg = np.empty((b, 1, 1, 3), np.float32)
        bg0 = np.empty_like(cx)
        bg1 = np.empty_like(cx)
        flips = np.empty((b,), bool)
        for j, i in enumerate(np.asarray(idx)):
            labels[j], cx[j], cy[j], r[j], fg[j, 0, 0], bg0[j], bg1[j], \
                flips[j] = self._params(int(i))

        dx = self._xx[None] - cx
        dy = self._yy[None] - cy
        adx, ady = np.abs(dx), np.abs(dy)
        rad = np.sqrt(dx * dx + dy * dy)
        d_all = np.stack([
            rad - r,                                         # disk
            np.maximum(adx, ady) - r,                        # square
            0.5 * np.maximum(dy - r, np.maximum(             # triangle
                -dy - r + 2 * adx, -dy - r)),
            np.abs(rad - r) - 0.35 * r,                      # ring
            np.minimum(np.maximum(adx - r, ady - 0.35 * r),  # cross
                       np.maximum(ady - r, adx - 0.35 * r)),
        ])
        d = d_all[labels % 5, np.arange(b)]
        aa = 1.5 / n  # anti-alias width
        mask = np.clip(0.5 - d / aa, 0.0, 1.0)[..., None]
        bg = (bg0 + (bg1 - bg0) * self._yy[None])[..., None]
        imgs = (bg * (1 - mask) + fg * mask).astype(np.float32)
        imgs[flips] = imgs[flips, :, ::-1]
        out = {"image": np.clip(imgs, -1.0, 1.0, out=imgs)}
        if self.num_classes > 0:
            out["label"] = labels
        return out


class ImageFolderDataset:
    """class-subdirectory image folder (CelebA / ImageNet / LSUN exports,
    reference: datasets/data_loader.py:134-196) with the exact ADM crop."""

    EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

    def __init__(self, root: str, image_size: int, random_crop=False,
                 flip=True, num_workers: int = 0):
        self.root = root
        self.image_size = image_size
        self.random_crop = random_crop
        self.flip = flip
        # Parallel JPEG decode + crop: the reference feeds this pipeline
        # with torch DataLoader workers (main.py num_workers); a serial
        # decode of batch_size images starves the train step on real folders.
        # The pool is created lazily (first get_batch) so the dataset object
        # stays picklable until it is actually used on this process.
        self._pool = None
        self._num_workers = int(num_workers or 0)
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        if classes:
            for c in classes:
                cdir = os.path.join(root, c)
                for fn in sorted(os.listdir(cdir)):
                    if fn.lower().endswith(self.EXTS):
                        self.samples.append(
                            (os.path.join(cdir, fn), self.class_to_idx[c])
                        )
        else:  # flat folder
            for fn in sorted(os.listdir(root)):
                if fn.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(root, fn), 0))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.samples)

    def _load(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB")
            if self.random_crop:
                arr = random_crop_arr(im, self.image_size)
            else:
                arr = center_crop_arr(im, self.image_size)
        if self.flip and random.random() < 0.5:
            arr = arr[:, ::-1]
        return arr

    def get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        paths = [self.samples[i][0] for i in idx]
        if self._pool is None and self._num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self._num_workers)
        if self._pool is not None:
            imgs = np.stack(list(self._pool.map(self._load, paths)))
        else:
            imgs = np.stack([self._load(p) for p in paths])
        labels = np.asarray([self.samples[i][1] for i in idx], np.int32)
        return {"image": _normalize(imgs), "label": labels}

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_pool"] = None  # executors don't pickle; recreated lazily
        return state


class LatentDataset:
    """VAE-latent HDF5 dataset (reference: datasets/data_loader.py:62-81).
    Items are [mean | std] 8-channel moment stacks
    (preprocessing/encode_latent.py:95-100), stored CHW in the reference —
    transposed to HWC here. The file handle stays open (chunk-cached) rather
    than reopening per item."""

    def __init__(self, h5_file: str, dataset_type: str = "train"):
        import h5py

        self.f = h5py.File(h5_file, "r")
        self.latents = self.f[f"{dataset_type}_latents"]
        self.labels = self.f[f"{dataset_type}_labels"]

    def __len__(self):
        return len(self.latents)

    @staticmethod
    def _sorted_read(ds, idx):
        order = np.argsort(idx)
        sorted_idx = idx[order]
        out = ds[sorted_idx.tolist()]
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return out[inv]

    def get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        lat = self._sorted_read(self.latents, np.asarray(idx))
        lab = self._sorted_read(self.labels, np.asarray(idx))
        lat = np.transpose(lat, (0, 2, 3, 1)).astype(np.float32)  # CHW->HWC
        return {"image": lat, "label": lab.astype(np.int32)}

    def get_slab(self, start: int, end: int) -> Dict[str, np.ndarray]:
        """Contiguous range read — HDF5 point selection costs one chunk
        lookup per index, ~10x slower than a slab read at batch sizes."""
        lat = np.transpose(
            self.latents[start:end], (0, 2, 3, 1)
        ).astype(np.float32)
        return {"image": lat,
                "label": self.labels[start:end].astype(np.int32)}


class LatentWithPixelDataset(LatentDataset):
    """Latent + uint8 pixels + label, for REPA teacher features
    (reference: datasets/data_loader.py:84-107)."""

    def __init__(self, h5_file: str, dataset_type: str = "train"):
        super().__init__(h5_file, dataset_type)
        self.pixels = self.f[f"{dataset_type}_pixels"]

    def get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        out = super().get_batch(idx)
        pix = self._sorted_read(self.pixels, np.asarray(idx))
        out["pixels"] = np.transpose(pix, (0, 2, 3, 1)).astype(np.float32)
        return out

    def get_slab(self, start: int, end: int) -> Dict[str, np.ndarray]:
        # MUST carry pixels too: load_dataset routes this dataset to
        # SlabShuffleLoader (hasattr get_slab), and the inherited slab read
        # would silently drop the REPA teacher input — the trainer would
        # fall back to treating the 8-channel moment stack as pixels.
        out = super().get_slab(start, end)
        out["pixels"] = np.transpose(
            self.pixels[start:end], (0, 2, 3, 1)).astype(np.float32)
        return out


# ------------------------------------------------------------------- #
# batch loader
# ------------------------------------------------------------------- #


class SlabShuffleLoader:
    """Two-stage shuffle for datasets with fast contiguous reads (HDF5
    latents): shuffle SLAB order across the file, read each ~slab_size-item
    slab sequentially, shuffle within the slab, emit whole batches (carrying
    remainders into the next slab). Random-access point selection in h5py
    costs one chunk lookup per item (~1.6k imgs/s measured); slab reads keep
    the pipeline >10x ahead of the train step. The standard tf.data-style
    trade: shuffle radius ~ slab_size instead of the full epoch."""

    def __init__(self, dataset, batch_size: int, slab_size: int = 8192,
                 shuffle=True, seed=0, drop_last=True, num_shards: int = 1,
                 shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.slab_size = max(slab_size, batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_index = shard_index

    def _shard_starts(self, starts):
        """Multi-host slab assignment with EXACT batch-count equality: only
        full slabs participate (the <slab_size tail is dropped — bounded,
        documented loss), then the list is cycle-padded so every shard gets
        the same number of equally-sized slabs. Unequal shard lengths would
        hang a multi-process run: a process whose forever() yields fewer (or
        zero) batches desyncs from the others' collectives."""
        n = len(self.dataset)
        full = [s for s in starts if s + self.slab_size <= n]
        if not full:
            raise ValueError(
                f"dataset of {n} items has no full slab of {self.slab_size}; "
                "lower slab_size below the dataset size for multi-process runs")
        per_shard = -(-len(full) // self.num_shards)
        total = per_shard * self.num_shards
        reps = -(-total // len(full))
        padded = (full * reps)[:total]
        return padded[self.shard_index::self.num_shards]

    def __len__(self):
        if self.num_shards > 1:
            n_slabs = len(self.dataset) // self.slab_size
            per_shard = -(-n_slabs // self.num_shards)
            samples = per_shard * self.slab_size
            return (samples // self.batch_size if self.drop_last
                    else math.ceil(samples / self.batch_size))
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size
        )

    def fast_forward(self, n_batches: int):
        """Resume determinism: advance from the loader's CURRENT position
        as if `n_batches` more had been consumed, so epoch-seeded
        permutations reproduce the uninterrupted run's batch sequence
        exactly (the reference gets this from DistributedSampler.set_epoch
        per step, tools/trainer.py:70-71). Relative, not absolute: the CLI
        (cli/main.py:init, as the JAX CLI) draws one shape-init batch
        before training, which starts an epoch, and the interrupted and the
        resumed run share that prefix. Within-epoch skipping re-reads the
        already-consumed slabs once — a bounded one-time resume cost."""
        per = len(self)
        if per <= 0:
            return
        self.epoch += n_batches // per
        self._skip = n_batches % per

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        skip = getattr(self, "_skip", 0)
        self._skip = 0
        for i, batch in enumerate(self._iter_epoch()):
            if i >= skip:
                yield batch

    def _iter_epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        starts = list(range(0, n, self.slab_size))
        rs = np.random.RandomState(self.seed + self.epoch)
        self.epoch += 1
        if self.shuffle:
            rs.shuffle(starts)
        if self.num_shards > 1:
            starts = self._shard_starts(starts)
        carry: Optional[Dict[str, np.ndarray]] = None
        for s in starts:
            slab = self.dataset.get_slab(s, min(s + self.slab_size, n))
            if carry is not None:
                slab = {k: np.concatenate([carry[k], slab[k]])
                        for k in slab}
                carry = None
            size = len(next(iter(slab.values())))
            if self.shuffle:
                perm = rs.permutation(size)
                slab = {k: v[perm] for k, v in slab.items()}
            full = size - size % self.batch_size
            for i in range(0, full, self.batch_size):
                yield {k: v[i: i + self.batch_size]
                       for k, v in slab.items()}
            if full < size:
                carry = {k: v[full:] for k, v in slab.items()}
        if carry is not None and not self.drop_last:
            yield carry

    def forever(self):
        while True:
            yield from self


class BatchLoader:
    """Shuffled epoch iterator producing whole batches (replacing per-rank
    DataLoaders + DistributedSampler, reference main.py:166-180)."""

    def __init__(self, dataset, batch_size: int, shuffle=True, seed=0,
                 drop_last=True, num_shards: int = 1, shard_index: int = 0):
        """num_shards/shard_index: multi-host strided sharding of each
        epoch's index permutation — every process sees a disjoint slice of
        the same shuffle (replaces DistributedSampler,
        reference main.py:166-180). The shuffle seed is shared so shards
        stay disjoint across processes."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __len__(self):
        # ceil-divide: shards are wrap-padded to equal length (see __iter__)
        n = -(-len(self.dataset) // self.num_shards)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size
        )

    def fast_forward(self, n_batches: int):
        """Resume determinism (see SlabShuffleLoader.fast_forward): advance
        the epoch counter and within-epoch batch offset from the CURRENT
        position to where an uninterrupted run would be after `n_batches`
        more."""
        per = len(self)
        if per <= 0:
            return
        self.epoch += n_batches // per
        self._skip = n_batches % per

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        skip = getattr(self, "_skip", 0)
        self._skip = 0
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            rs.shuffle(idx)
        if self.num_shards > 1:
            # pad with wrap-around so every process gets the SAME number of
            # indices/batches (DistributedSampler semantics, reference
            # main.py:166-180) — unequal shards would desync collective
            # epoch-aligned consumers across hosts
            total = -(-n // self.num_shards) * self.num_shards
            if total > n:
                idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.shard_index::self.num_shards]
        self.epoch += 1
        n = len(idx)
        end = n - n % self.batch_size if self.drop_last else n
        for i in range(skip * self.batch_size, end, self.batch_size):
            yield self.dataset.get_batch(idx[i: i + self.batch_size])

    def forever(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield from iter(self)


def load_dataset(data_dir: str, dataset: str, batch_size: int,
                 image_size: int, num_workers: int = 0, shuffle: bool = True,
                 seed: int = 0, num_classes: int = 0, channels: int = 3,
                 num_shards: int = 1, shard_index: int = 0):
    """Unified loader (reference: datasets/data_loader.py:199-224). Returns
    (train_loader, test_loader). num_shards/shard_index give each multi-host
    process a disjoint shard (replaces DistributedSampler,
    reference main.py:166-180)."""
    if dataset == "CIFAR-10":
        train = Cifar10Dataset(data_dir, train=True)
        test = Cifar10Dataset(data_dir, train=False, flip=False)
    elif dataset == "Gaussian":
        train = GaussianDataset(image_size=image_size, channels=channels,
                                num_classes=num_classes)
        test = GaussianDataset(image_size=image_size, channels=channels,
                               num_classes=num_classes, length=10_000,
                               seed=1)
    elif dataset == "Shapes":
        nc = num_classes or ShapesDataset.NUM_CLASSES
        train = ShapesDataset(image_size=image_size, num_classes=nc)
        test = ShapesDataset(image_size=image_size, num_classes=nc,
                             length=10_000, seed=1, flip=False)
    elif dataset in ("CelebA", "ImageNet", "LSUN"):
        sub = {"CelebA": "celeba", "ImageNet": "train", "LSUN": "lsun"}
        root = os.path.join(data_dir, sub.get(dataset, ""))
        if not os.path.isdir(root):
            root = data_dir
        train = ImageFolderDataset(root, image_size, random_crop=False,
                                   num_workers=num_workers)
        test = train
    elif dataset == "Latent":
        path = data_dir if data_dir.endswith(".h5") else os.path.join(
            data_dir, "latents.h5"
        )
        train = LatentDataset(path, "train")
        test = LatentDataset(path, "train")
    elif dataset == "Latent_Pixel":
        path = data_dir if data_dir.endswith(".h5") else os.path.join(
            data_dir, "latents.h5"
        )
        train = LatentWithPixelDataset(path, "train")
        test = LatentWithPixelDataset(path, "train")
    else:
        raise ValueError(f"Unsupported dataset: {dataset}")
    # Latent HDF5 datasets stream fastest via slab-sequential reads.
    train_cls = (
        SlabShuffleLoader if hasattr(train, "get_slab") else BatchLoader
    )
    return (
        train_cls(train, batch_size, shuffle=shuffle, seed=seed,
                  num_shards=num_shards, shard_index=shard_index),
        BatchLoader(test, batch_size, shuffle=False, seed=seed,
                    num_shards=num_shards, shard_index=shard_index),
    )


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
