"""FID / sFID / Inception Score / precision-recall math (counterpart of
vaw_tpu/evals/fid.py; reference: evaluations/evaluator.py:68-412).

The Frechet distance keeps scipy's ``sqrtm`` on the host in f64, as the
JAX package does. The pairwise-distance block behind precision and recall
(``pairwise_sq_distances``) runs on the estimator's device in f32 with
TF32 off (``full_f32``): on an H100 PyTorch would otherwise take f32
products through TF32, whose 10-bit mantissa moves the k-NN radii and so
precision and recall; the JAX package accumulates that matmul in f32.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
from scipy import linalg

__all__ = [
    "FIDStatistics",
    "compute_statistics",
    "compute_inception_score_from_probs",
    "ManifoldEstimator",
    "pairwise_sq_distances",
    "full_f32",
]


@contextlib.contextmanager
def full_f32():
    """f32 products and convolutions with TF32 off (cuBLAS and cuDNN), the
    previous settings restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


class FIDStatistics:
    """mu/sigma pair and the Frechet distance between two of them
    (reference: evaluations/evaluator.py:68-116)."""

    def __init__(self, mu: np.ndarray, sigma: np.ndarray):
        self.mu = mu
        self.sigma = sigma

    def frechet_distance(self, other: "FIDStatistics", eps=1e-6) -> float:
        mu1, sigma1 = np.atleast_1d(self.mu), np.atleast_2d(self.sigma)
        mu2, sigma2 = np.atleast_1d(other.mu), np.atleast_2d(other.sigma)
        if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
            raise ValueError(f"statistics of different widths: {mu1.shape} vs {mu2.shape}")
        diff = mu1 - mu2
        # No `disp` (scipy 1.18 removed it): the same square root, without
        # the error estimate that the JAX package discards.
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            warnings.warn("fid calculation produces singular product; adding "
                          f"{eps} to diagonal of cov estimates")
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
            covmean = covmean.real
        return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                     - 2 * np.trace(covmean))


def compute_statistics(activations: np.ndarray) -> FIDStatistics:
    """(reference: evaluations/evaluator.py:175-178)"""
    return FIDStatistics(np.mean(activations, axis=0), np.cov(activations, rowvar=False))


def compute_inception_score_from_probs(preds: np.ndarray, split_size: int = 5000) -> float:
    """exp(E KL(p(y|x) || p(y))) over splits of 5000
    (reference: evaluations/evaluator.py:180-193)."""
    scores = []
    for i in range(0, len(preds), split_size):
        part = preds[i: i + split_size]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores))


def pairwise_sq_distances(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """max(|u|^2 - 2 u.v + |v|^2, 0) for f32 rows u [R, F] and v [C, F]
    (reference formula: evaluations/evaluator.py:415-431), TF32 off."""
    with full_f32():
        norm_u = (u * u).sum(dim=1)[:, None]
        norm_v = (v * v).sum(dim=1)[None, :]
        return torch.clamp(norm_u - 2.0 * (u @ v.T) + norm_v, min=0.0)


class ManifoldEstimator:
    """Improved-precision-and-recall manifold estimator
    (reference: evaluations/evaluator.py:206-360), its distance blocks on
    `device`."""

    def __init__(self, row_batch_size=10000, col_batch_size=10000, nhood_sizes=(3,),
                 clamp_to_percentile=None, eps=1e-5, device="cuda"):
        self.row_batch_size = row_batch_size
        self.col_batch_size = col_batch_size
        self.nhood_sizes = nhood_sizes
        self.num_nhoods = len(nhood_sizes)
        self.clamp_to_percentile = clamp_to_percentile
        self.eps = eps
        self.device = torch.device(device)

    def _block(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        return pairwise_sq_distances(put(rows), put(cols)).cpu().numpy()

    def manifold_radii(self, features: np.ndarray) -> np.ndarray:
        """k-NN distance radii per sample
        (reference: evaluations/evaluator.py:249-283)."""
        num_images = len(features)
        radii = np.zeros([num_images, self.num_nhoods], dtype=np.float32)
        kth = list(self.nhood_sizes)
        for begin1 in range(0, num_images, self.row_batch_size):
            end1 = min(begin1 + self.row_batch_size, num_images)
            rows = features[begin1:end1]
            dist = np.zeros([end1 - begin1, num_images], np.float32)
            for begin2 in range(0, num_images, self.col_batch_size):
                end2 = min(begin2 + self.col_batch_size, num_images)
                dist[:, begin2:end2] = self._block(rows, features[begin2:end2])
            radii[begin1:end1, :] = np.partition(dist, kth, axis=1)[:, kth]
        if self.clamp_to_percentile is not None:
            max_d = np.percentile(radii, self.clamp_to_percentile, axis=0)
            radii[radii > max_d] = 0
        return radii

    def evaluate(self, features: np.ndarray, radii: np.ndarray, eval_features: np.ndarray):
        """Membership and realism scores
        (reference: evaluations/evaluator.py:285-323)."""
        num_eval = eval_features.shape[0]
        predictions = np.zeros([num_eval, self.num_nhoods], np.int32)
        realism = np.zeros([num_eval], np.float32)
        nearest = np.zeros([num_eval], np.int32)
        for begin1 in range(0, num_eval, self.row_batch_size):
            end1 = min(begin1 + self.row_batch_size, num_eval)
            rows = eval_features[begin1:end1]
            dist = np.zeros([end1 - begin1, len(features)], np.float32)
            for begin2 in range(0, len(features), self.col_batch_size):
                end2 = min(begin2 + self.col_batch_size, len(features))
                dist[:, begin2:end2] = self._block(rows, features[begin2:end2])
            predictions[begin1:end1] = np.any(dist[:, :, None] <= radii, axis=1)
            realism[begin1:end1] = np.max(radii[:, 0] / (dist + self.eps), axis=1)
            nearest[begin1:end1] = np.argmin(dist, axis=1)
        return {"fraction": float(np.mean(predictions)), "batch_predictions": predictions,
                "max_realisim_score": realism, "nearest_indices": nearest}

    def evaluate_pr(self, features_1, radii_1, features_2, radii_2):
        """Symmetric membership sweep: (precision, recall)
        (reference: evaluations/evaluator.py:325-360)."""
        status_1 = np.zeros([len(features_1), radii_2.shape[1]], dtype=bool)
        status_2 = np.zeros([len(features_2), radii_1.shape[1]], dtype=bool)
        for b1 in range(0, len(features_1), self.row_batch_size):
            e1 = min(b1 + self.row_batch_size, len(features_1))
            batch_1 = features_1[b1:e1]
            for b2 in range(0, len(features_2), self.col_batch_size):
                e2 = min(b2 + self.col_batch_size, len(features_2))
                dist = self._block(batch_1, features_2[b2:e2])  # [r, c]
                status_1[b1:e1] |= np.any(dist[:, :, None] <= radii_2[b2:e2][None], axis=1)
                status_2[b2:e2] |= np.any(dist[:, :, None] <= radii_1[b1:e1][:, None],
                                          axis=0)
        return (np.mean(status_2.astype(np.float64), axis=0),  # precision
                np.mean(status_1.astype(np.float64), axis=0))  # recall
