"""The port's preprocessing tools (vaw_torch/data/preprocessing.py:
resize_imagenet, preprocess_celeba, export_lsun, compute_ref_stats) against
the JAX package's (vaw_tpu/data/preprocessing.py) on the same seeded
inputs.

Tolerances: the three image tools are the same PIL calls on both sides, so
their files decode to equal arrays, in the same tree. compute_ref_stats
runs the same fake Inception backend (tests/test_torch_evals.py) and the
same numpy statistics on both sides: mu, sigma, mu_s and sigma_s within
1e-6 relative, arr_0 equal.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
from _torch_preprocess_inputs import (
    fake_lmdb,
    lsun_values,
    tree,
    write_celeba,
    write_imagenet_tree,
    write_png_tree,
)
from test_torch_evals import _FakeBackend

from vaw_torch.data import preprocessing as port
from vaw_torch.evals import evaluator as port_evaluator
from vaw_tpu.data import preprocessing as jax_pre
from vaw_tpu.evals import evaluator as jax_evaluator


@pytest.mark.parametrize("image_size", [32, 64])
def test_resize_imagenet_writes_the_jax_tree(tmp_path, image_size):
    src = write_imagenet_tree(tmp_path / "in")
    n_port = port.resize_imagenet(str(src), str(tmp_path / "port"), image_size, workers=3)
    n_jax = jax_pre.resize_imagenet(str(src), str(tmp_path / "jax"), image_size, workers=3)
    assert n_port == n_jax == 9
    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 9
    for name in want:
        assert got[name].shape == (image_size, image_size, 3), name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_preprocess_celeba_writes_the_jax_tree(tmp_path):
    root = write_celeba(tmp_path / "celeba")
    assert port.preprocess_celeba(str(root), str(tmp_path / "port")) == str(tmp_path / "port")
    jax_pre.preprocess_celeba(str(root), str(tmp_path / "jax"))
    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert list(got) == list(want)
    assert sum(name.startswith("train/celeba/") for name in got) == 12
    assert sum(name.startswith(("val/", "test/")) for name in got) == 4
    for name in want:
        assert got[name].shape == (64, 64, 3)
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("limit", [None, 4])
def test_export_lsun_writes_the_jax_pngs(tmp_path, monkeypatch, limit):
    db = str(tmp_path / "bedroom_train_lmdb")
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb({db: lsun_values()}))
    n_port = port.export_lsun(db, str(tmp_path / "port"), image_size=32, limit=limit)
    n_jax = jax_pre.export_lsun(db, str(tmp_path / "jax"), image_size=32, limit=limit)
    assert n_port == n_jax == (limit or 6)
    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert list(got) == list(want) == [f"{i:07d}.png" for i in range(n_jax)]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_export_lsun_names_the_missing_lmdb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb raises ImportError
    with pytest.raises(ImportError, match="lmdb"):
        port.export_lsun(str(tmp_path / "db"), str(tmp_path / "out"))


def _fake_inception(monkeypatch):
    monkeypatch.setattr(port_evaluator, "make_inception_backend", _FakeBackend)
    monkeypatch.setattr(jax_evaluator, "make_inception_backend", _FakeBackend)


@pytest.mark.parametrize("batch_size", [7, 64])
def test_compute_ref_stats_writes_the_jax_npz(tmp_path, monkeypatch, batch_size):
    _fake_inception(monkeypatch)
    pngs = write_png_tree(tmp_path / "pngs")
    got_path = port.compute_ref_stats(str(pngs), "tiny", 16, batch_size,
                                      str(tmp_path / "port.npz"), device="cpu")
    want_path = jax_pre.compute_ref_stats(str(pngs), "tiny", 16, batch_size,
                                          str(tmp_path / "jax.npz"))
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files) == ["arr_0", "mu", "mu_s",
                                                           "sigma", "sigma_s"]
        for k in ("mu", "sigma", "mu_s", "sigma_s"):
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
        assert got["arr_0"].dtype == np.uint8 and got["arr_0"].shape == (20, 16, 16, 3)
        np.testing.assert_array_equal(got["arr_0"], want["arr_0"])


def test_compute_ref_stats_default_name_and_no_pngs(tmp_path, monkeypatch):
    _fake_inception(monkeypatch)
    pngs = write_png_tree(tmp_path / "pngs", n=3)
    monkeypatch.chdir(tmp_path)
    path = port.compute_ref_stats(str(pngs), "cifar10", 16, device="cpu")
    assert path == "./VIRTUAL_cifar1016.npz" and (tmp_path / "VIRTUAL_cifar1016.npz").exists()
    with pytest.raises(FileNotFoundError, match="no PNGs"):
        port.compute_ref_stats(str(tmp_path / "empty"), "x", 16, device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_ref_sample_draws_10000_as_the_jax_tool_does(seed):
    images = np.arange(10037, dtype=np.int64)[:, None, None, None]
    want = images[np.random.RandomState(seed).choice(10037, 10000, replace=False)]
    got = port.ref_sample(images, seed)
    assert got.shape == (10000, 1, 1, 1) and len(np.unique(got)) == 10000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.ref_sample(images[:10000], seed), images[:10000])
