"""Parity of the port's datasets and loaders (vaw_torch/data/datasets.py)
with the JAX package's (vaw_tpu/data/datasets.py).

Every dataset class gives batches bit-equal to JAX's for the same seed and
indices: Shapes and Gaussian, CIFAR-10 from a small archive (its flips
draw from numpy's global generator, so both sides start from one
np.random.seed), an image folder of small PNGs (random crops and flips
draw from Python's random, so both start from one random.seed), and the
latent HDF5 sets. Both loaders give JAX's batch sequence over two epochs,
with and without shards, and resume bit-equal after fast_forward.
"""

from __future__ import annotations

import pickle
import random

import numpy as np
import pytest

from vaw_torch.data import datasets as td
from vaw_torch.runtime import native
from vaw_tpu.data import datasets as jd

h5py = pytest.importorskip("h5py")


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    base = root / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (12, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 12).tolist()}, f)
    return root


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(1)
    for i, cls in enumerate(["cat", "cat", "cat", "dog", "dog", "owl", "owl"]):
        (root / cls).mkdir(exist_ok=True)
        h, w = int(rng.integers(20, 48)), int(rng.integers(20, 48))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / cls / f"{i}.png")
    return root


@pytest.fixture(scope="module")
def latents_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("latents") / "latents.h5"
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        f["train_latents"] = rng.standard_normal((40, 8, 4, 4)).astype(np.float32)
        f["train_labels"] = rng.integers(0, 1000, 40).astype(np.uint16)
        f["train_pixels"] = rng.integers(0, 256, (40, 3, 16, 16), dtype=np.uint8)
    return str(path)


IDX = np.array([5, 0, 11, 3, 7, 9])  # distinct: h5py reads strictly increasing points


@pytest.mark.parametrize("kwargs", [
    dict(image_size=8, num_classes=10), dict(image_size=16, num_classes=4, seed=3),
    dict(image_size=12, num_classes=10, flip=False)])
def test_shapes_batches_bit_equal(kwargs):
    _assert_batches_equal(td.ShapesDataset(**kwargs).get_batch(IDX),
                          jd.ShapesDataset(**kwargs).get_batch(IDX))


@pytest.mark.parametrize("num_classes", [0, 7])
def test_gaussian_batches_bit_equal(num_classes):
    kw = dict(image_size=4, channels=3, num_classes=num_classes, seed=2)
    _assert_batches_equal(td.GaussianDataset(**kw).get_batch(IDX),
                          jd.GaussianDataset(**kw).get_batch(IDX))


@pytest.mark.parametrize("train,flip", [(True, True), (True, False), (False, True)])
def test_cifar_batches_bit_equal(cifar_dir, train, flip):
    tds = td.Cifar10Dataset(str(cifar_dir), train=train, flip=flip)
    jds = jd.Cifar10Dataset(str(cifar_dir), train=train, flip=flip)
    assert len(tds) == (60 if train else 12)
    before = native.gather_normalize.calls
    np.random.seed(4)
    got = tds.get_batch(IDX)
    np.random.seed(4)
    want = jds.get_batch(IDX)
    _assert_batches_equal(got, want)
    assert native.gather_normalize.calls == before + 1  # the native gather


@pytest.mark.parametrize("random_crop,flip,workers", [
    (False, False, 0), (False, True, 0), (True, True, 0), (False, False, 3)])
def test_image_folder_batches_bit_equal(image_dir, random_crop, flip, workers):
    tds = td.ImageFolderDataset(str(image_dir), 16, random_crop=random_crop,
                                flip=flip, num_workers=workers)
    jds = jd.ImageFolderDataset(str(image_dir), 16, random_crop=random_crop,
                                flip=flip, num_workers=workers)
    assert tds.samples == jds.samples and tds.class_to_idx == jds.class_to_idx
    idx = np.array([6, 0, 3, 2])
    random.seed(5)
    got = tds.get_batch(idx)
    random.seed(5)
    want = jds.get_batch(idx)
    _assert_batches_equal(got, want)
    assert pickle.loads(pickle.dumps(tds))._pool is None  # the pool is not pickled
    tds.close()
    jds.close()


def test_crops_bit_equal():
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (90, 130, 3), dtype=np.uint8))
    np.testing.assert_array_equal(td.center_crop_arr(img, 32),
                                  jd.center_crop_arr(img, 32))
    random.seed(7)
    got = td.random_crop_arr(img, 24)
    random.seed(7)
    np.testing.assert_array_equal(got, jd.random_crop_arr(img, 24))


@pytest.mark.parametrize("cls", ["LatentDataset", "LatentWithPixelDataset"])
def test_latent_batches_and_slabs_bit_equal(latents_h5, cls):
    tds, jds = getattr(td, cls)(latents_h5), getattr(jd, cls)(latents_h5)
    assert len(tds) == len(jds) == 40
    _assert_batches_equal(tds.get_batch(IDX), jds.get_batch(IDX))
    _assert_batches_equal(tds.get_slab(3, 17), jds.get_slab(3, 17))
    if cls == "LatentWithPixelDataset":
        assert tds.get_slab(3, 17)["pixels"].shape == (14, 16, 16, 3)


def _sequence(loader, n):
    it = loader.forever()
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("num_shards,shard_index", [(1, 0), (3, 0), (3, 2)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_loader_sequence_and_resume(num_shards, shard_index, shuffle):
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, num_shards=num_shards,
              shard_index=shard_index)
    tds = td.GaussianDataset(image_size=2, channels=1, num_classes=3, length=26)
    jds = jd.GaussianDataset(image_size=2, channels=1, num_classes=3, length=26)
    tl, jl = td.BatchLoader(tds, **kw), jd.BatchLoader(jds, **kw)
    assert len(tl) == len(jl)
    per = len(tl)
    want = _sequence(jl, 2 * per + 1)  # two epochs and one batch
    for got, ref in zip(_sequence(tl, 2 * per + 1), want):
        _assert_batches_equal(got, ref)
    for n in (1, per, per + 2):
        resumed = td.BatchLoader(tds, **kw)
        resumed.fast_forward(n)
        for got, ref in zip(_sequence(resumed, 2 * per + 1 - n), want[n:]):
            _assert_batches_equal(got, ref)


class _SlabData:
    """get_slab over 0..n-1, as td and jd slab datasets expose it."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_slab(self, a, b):
        return {"image": np.arange(a, b, dtype=np.float32)[:, None],
                "label": np.arange(a, b, dtype=np.int32)}


@pytest.mark.parametrize("num_shards,shard_index", [(1, 0), (2, 1), (3, 0)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_slab_loader_sequence_and_resume(num_shards, shard_index, drop_last):
    kw = dict(batch_size=3, slab_size=8, shuffle=True, seed=3, drop_last=drop_last,
              num_shards=num_shards, shard_index=shard_index)
    tl, jl = td.SlabShuffleLoader(_SlabData(37), **kw), jd.SlabShuffleLoader(
        _SlabData(37), **kw)
    assert len(tl) == len(jl)
    epochs_t = [list(tl) for _ in range(2)]
    epochs_j = [list(jl) for _ in range(2)]
    for et, ej in zip(epochs_t, epochs_j):
        assert len(et) == len(ej)
        for got, ref in zip(et, ej):
            _assert_batches_equal(got, ref)
    if drop_last:  # the CLI fast-forwards only loaders with full batches
        per = len(tl)
        want = _sequence(jd.SlabShuffleLoader(_SlabData(37), **kw), 2 * per)
        for n in (2, per + 1):
            resumed = td.SlabShuffleLoader(_SlabData(37), **kw)
            resumed.fast_forward(n)
            for got, ref in zip(_sequence(resumed, 2 * per - n), want[n:]):
                _assert_batches_equal(got, ref)


def test_slab_loader_on_latents_bit_equal(latents_h5):
    kw = dict(batch_size=6, slab_size=16, seed=1)
    got = _sequence(td.SlabShuffleLoader(td.LatentDataset(latents_h5), **kw), 12)
    want = _sequence(jd.SlabShuffleLoader(jd.LatentDataset(latents_h5), **kw), 12)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_loaders_refuse_a_shard_outside_the_range():
    with pytest.raises(ValueError, match="shard_index"):
        td.BatchLoader(td.GaussianDataset(length=8), 2, num_shards=2, shard_index=2)
    with pytest.raises(ValueError, match="shard_index"):
        td.SlabShuffleLoader(_SlabData(8), 2, num_shards=1, shard_index=1)
    with pytest.raises(ValueError, match="no full slab"):
        next(iter(td.SlabShuffleLoader(_SlabData(8), 2, slab_size=16,
                                       num_shards=2)))


@pytest.mark.parametrize("dataset", ["Gaussian", "Shapes", "CIFAR-10", "ImageNet",
                                     "Latent", "Latent_Pixel"])
def test_load_dataset_routes_every_dataset_as_jax(dataset, cifar_dir, image_dir,
                                                  latents_h5):
    data_dir = {"CIFAR-10": str(cifar_dir), "ImageNet": str(image_dir),
                "Latent": latents_h5, "Latent_Pixel": latents_h5}.get(dataset, "/none")
    # One decode thread: a pool's threads would draw the flips from Python's
    # random in no fixed order.
    kw = dict(batch_size=4, image_size=16, num_workers=0, seed=3, num_classes=5,
              channels=3)
    t_train, t_test = td.load_dataset(data_dir, dataset, **kw)
    j_train, j_test = jd.load_dataset(data_dir, dataset, **kw)
    assert type(t_train).__name__ == type(j_train).__name__
    assert type(t_train.dataset).__name__ == type(j_train.dataset).__name__
    assert type(t_test).__name__ == type(j_test).__name__ == "BatchLoader"
    assert len(t_train) == len(j_train) and len(t_test) == len(j_test)
    for t_loader, j_loader in ((t_train, j_train), (t_test, j_test)):
        np.random.seed(8)
        random.seed(8)
        got = next(iter(t_loader))
        np.random.seed(8)
        random.seed(8)
        _assert_batches_equal(got, next(iter(j_loader)))
    if dataset == "ImageNet":
        kw["num_workers"] = 3
        assert td.load_dataset(data_dir, dataset, **kw)[0].dataset._num_workers == 3


def test_load_dataset_refuses_an_unknown_dataset():
    with pytest.raises(ValueError, match="Unsupported dataset"):
        td.load_dataset("/none", "MNIST", 4, 8)
