"""Evaluation: the frozen InceptionV3 graph on the device (read with no
TensorFlow), FID, sFID, IS, precision and recall (counterpart of
vaw_tpu/evals)."""

from .evaluator import Evaluator
from .fid import (
    FIDStatistics,
    ManifoldEstimator,
    compute_inception_score_from_probs,
    compute_statistics,
    pairwise_sq_distances,
)
from .npz_reader import open_npz_array

__all__ = [
    "Evaluator", "FIDStatistics", "ManifoldEstimator",
    "compute_inception_score_from_probs", "compute_statistics",
    "pairwise_sq_distances", "open_npz_array",
]
