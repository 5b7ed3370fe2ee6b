"""Parity of the port's metrics (vaw_torch/evals: fid.py, npz_reader.py,
evaluator.py) with the JAX package's (vaw_tpu/evals) on the same numpy
inputs: the Frechet distance, the Inception Score, the pairwise distance
block, the k-NN radii, precision and recall, the streaming npz reader, and
the Evaluator's methods end to end over a fake Inception backend (a fixed
seeded projection of the images, the same object on both sides).

Tolerances: the Frechet distance and IS are the same numpy/scipy code on
both sides: equal to 1e-9 relative. The distance block is f32 on both
sides in another summation order: within 1e-5 of max|d|. Radii, precision
and recall come from those distances: radii within 1e-5 relative, the
membership fractions equal (the inputs keep every distance far from a
radius, checked).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vaw_torch.evals import evaluator as port_evaluator
from vaw_torch.evals import fid as port_fid
from vaw_torch.evals import open_npz_array as port_open_npz
from vaw_tpu.evals import evaluator as jax_evaluator
from vaw_tpu.evals import fid as jax_fid
from vaw_tpu.evals import open_npz_array as jax_open_npz


def _features(n, f, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, f)) + shift).astype(np.float32)


def test_frechet_distance_and_statistics():
    a, b = _features(300, 16, 0), _features(250, 16, 1, shift=0.3)
    pa, pb = port_fid.compute_statistics(a), port_fid.compute_statistics(b)
    ja, jb = jax_fid.compute_statistics(a), jax_fid.compute_statistics(b)
    np.testing.assert_array_equal(pa.mu, ja.mu)
    np.testing.assert_array_equal(pa.sigma, ja.sigma)
    got, want = pa.frechet_distance(pb), ja.frechet_distance(jb)
    assert want > 0.1
    assert abs(got - want) <= 1e-9 * abs(want)
    assert abs(pa.frechet_distance(pa)) < 1e-6
    with pytest.raises(ValueError, match="widths"):
        pa.frechet_distance(port_fid.compute_statistics(_features(10, 8, 2)))


@pytest.mark.parametrize("split", [5000, 40])
def test_inception_score(split):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((100, 10)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got = port_fid.compute_inception_score_from_probs(probs, split)
    want = jax_fid.compute_inception_score_from_probs(probs, split)
    assert abs(got - want) <= 1e-9 * want


def test_pairwise_sq_distances_and_tf32_restored():
    u, v = _features(70, 32, 4), _features(50, 32, 5)
    got = port_fid.pairwise_sq_distances(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    want = np.asarray(jax_fid.pairwise_sq_distances(u, v))
    exact = ((u[:, None].astype(np.float64) - v[None]) ** 2).sum(-1)
    assert np.abs(got - want).max() <= 1e-5 * want.max()
    assert np.abs(got - exact).max() <= 1e-5 * exact.max()
    assert (got >= 0).all()
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with port_fid.full_f32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


@pytest.mark.parametrize("rows", [10000, 37])  # one block, and several of both
def test_radii_precision_recall(rows):
    ref, sample = _features(120, 24, 6), _features(90, 24, 7, shift=0.25)
    port = port_fid.ManifoldEstimator(row_batch_size=rows, col_batch_size=rows,
                                      device="cpu")
    jax_est = jax_fid.ManifoldEstimator(row_batch_size=rows, col_batch_size=rows)
    r_port, r_jax = port.manifold_radii(ref), jax_est.manifold_radii(ref)
    np.testing.assert_allclose(r_port, r_jax, rtol=1e-5)
    s_port, s_jax = port.manifold_radii(sample), jax_est.manifold_radii(sample)
    # no distance lies within 1e-5 of a radius (relative), beyond the f32
    # rounding of either side, so the memberships cannot flip
    d = ((ref[:, None].astype(np.float64) - sample[None]) ** 2).sum(-1)
    assert np.abs(d[:, :, None] - s_jax[None]).min() > 1e-5 * d.max()
    assert np.abs(d[:, :, None] - r_jax[:, None]).min() > 1e-5 * d.max()
    got = port.evaluate_pr(ref, r_port, sample, s_port)
    want = jax_est.evaluate_pr(ref, r_jax, sample, s_jax)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert 0 < got[0][0] < 1 and 0 < got[1][0] < 1
    e_port = port.evaluate(ref, r_port, sample)
    e_jax = jax_est.evaluate(ref, r_jax, sample)
    assert e_port["fraction"] == e_jax["fraction"]
    np.testing.assert_array_equal(e_port["nearest_indices"], e_jax["nearest_indices"])
    np.testing.assert_allclose(e_port["max_realisim_score"], e_jax["max_realisim_score"],
                               rtol=1e-4)


@pytest.mark.parametrize("batch", [7, 64])
def test_npz_reader_streams_the_same_batches(tmp_path, batch):
    arr = np.random.default_rng(8).integers(0, 256, (30, 5, 5, 3), dtype=np.uint8)
    path = str(tmp_path / "a.npz")
    np.savez(path, arr, np.arange(30))
    with port_open_npz(path, "arr_0") as p, jax_open_npz(path, "arr_0") as j:
        got, want = list(p.read_batches(batch)), list(j.read_batches(batch))
    assert len(got) == len(want) == -(-30 // batch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(got), arr)
    with pytest.raises(ValueError, match="missing"):
        with port_open_npz(path, "arr_7"):
            pass


class _FakeBackend:
    """Pool features: a fixed projection of the 8x8-average-pooled image to
    12 values; spatial: the pooled image; softmax over pool @ W."""

    def __init__(self, *args, **kwargs):
        rng = np.random.default_rng(9)
        self.proj = rng.standard_normal((8 * 8 * 3, 12)).astype(np.float32) / 20
        self.w = rng.standard_normal((12, 6)).astype(np.float32)

    def features(self, batch):
        x = np.asarray(batch, np.float32)
        n, h, w, c = x.shape
        pooled = x.reshape(n, 8, h // 8, 8, w // 8, c).mean((2, 4)).reshape(n, -1) / 255
        return pooled @ self.proj * 10, pooled

    def softmax_probs(self, pool):
        logits = pool @ self.w
        e = np.exp(logits - logits.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)


def test_evaluator_with_a_fake_backend(tmp_path, monkeypatch):
    monkeypatch.setattr(port_evaluator, "make_inception_backend", _FakeBackend)
    monkeypatch.setattr(jax_evaluator, "make_inception_backend", _FakeBackend)
    rng = np.random.default_rng(10)
    ref = rng.integers(0, 256, (40, 16, 16, 3), dtype=np.uint8)
    sample = np.clip(ref[::-1] * 0.8 + rng.normal(20, 12, ref.shape), 0, 255).astype(np.uint8)
    paths = {}
    for name, arr in (("ref", ref), ("sample", sample)):
        paths[name] = str(tmp_path / f"{name}.npz")
        np.savez(paths[name], arr)
    port = port_evaluator.Evaluator(batch_size=16, device="cpu")
    jax_ev = jax_evaluator.Evaluator(batch_size=16)
    results = []
    for ev in (port, jax_ev):
        ref_acts = ev.read_activations(paths["ref"])
        ref_stats, ref_sp = ev.read_statistics(paths["ref"], ref_acts)
        acts = ev.compute_activations([sample[i:i + 16] for i in range(0, 40, 16)])
        stats, sp = (ev.compute_statistics(a) for a in acts)
        results.append((ev.compute_inception_score(acts[0]),
                        stats.frechet_distance(ref_stats), sp.frechet_distance(ref_sp),
                        *ev.compute_prec_recall(ref_acts[0], acts[0])))
    got, want = results
    assert want[1] > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # precomputed statistics in the reference npz are read, not recomputed
    stats_path = str(tmp_path / "stats.npz")
    np.savez(stats_path, mu=np.ones(3), sigma=np.eye(3), mu_s=np.zeros(2), sigma_s=np.eye(2))
    mu_stats, _ = port.read_statistics(stats_path, None)
    np.testing.assert_array_equal(mu_stats.mu, np.ones(3))
