"""Evaluator: FID / sFID / IS / precision / recall over sample batches
(counterpart of vaw_tpu/evals/evaluator.py; reference:
evaluations/evaluator.py:28-203), with the same methods and the same
standalone command:

    python -m vaw_torch.evals.evaluator ref.npz sample.npz

The Inception features and the distance blocks run on the evaluator's
device (the first CUDA card; ``VAW_PLATFORM=cpu`` selects the CPU), the
statistics and the Frechet distance on the host.
"""

from __future__ import annotations

import argparse
from typing import Iterable, Optional, Tuple

import numpy as np

from .fid import (
    FIDStatistics,
    ManifoldEstimator,
    compute_inception_score_from_probs,
    compute_statistics,
)
from .inception import make_inception_backend
from .npz_reader import open_npz_array

__all__ = ["Evaluator", "main"]


class Evaluator:
    def __init__(self, batch_size: int = 64, softmax_batch_size: int = 512,
                 pb_path: Optional[str] = None, backend: str = "auto", device="cuda"):
        self.batch_size = batch_size
        self.backend = make_inception_backend(
            backend, pb_path=pb_path, batch_size=batch_size,
            softmax_batch_size=softmax_batch_size, device=device)
        self.manifold_estimator = ManifoldEstimator(device=device)

    def warmup(self):
        self.compute_activations([np.zeros([1, 64, 64, 3])])

    def read_activations(self, npz_path: str):
        """(reference: evaluations/evaluator.py:139-141)"""
        with open_npz_array(npz_path, "arr_0") as reader:
            return self.compute_activations(reader.read_batches(self.batch_size))

    def compute_activations(self, batches: Iterable[np.ndarray]
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """NHWC [0, 255] batches -> (pool, spatial) feature matrices
        (reference: evaluations/evaluator.py:143-163)."""
        preds, spatial_preds = [], []
        for batch in batches:
            pool, spatial = self.backend.features(batch)
            preds.append(pool)
            spatial_preds.append(spatial)
        return np.concatenate(preds), np.concatenate(spatial_preds)

    def read_statistics(self, npz_path: str, activations):
        """Precomputed mu/sigma where the npz holds them, else those of
        `activations` (reference: evaluations/evaluator.py:165-172)."""
        with np.load(npz_path) as obj:
            if "mu" in obj.files:
                return (FIDStatistics(obj["mu"], obj["sigma"]),
                        FIDStatistics(obj["mu_s"], obj["sigma_s"]))
        return tuple(compute_statistics(x) for x in activations)

    def compute_statistics(self, activations: np.ndarray) -> FIDStatistics:
        return compute_statistics(activations)

    def compute_inception_score(self, activations: np.ndarray,
                                split_size: int = 5000) -> float:
        return compute_inception_score_from_probs(
            self.backend.softmax_probs(activations), split_size)

    def compute_prec_recall(self, activations_ref, activations_sample):
        """(reference: evaluations/evaluator.py:195-203)"""
        radii_1 = self.manifold_estimator.manifold_radii(activations_ref)
        radii_2 = self.manifold_estimator.manifold_radii(activations_sample)
        pr = self.manifold_estimator.evaluate_pr(activations_ref, radii_1,
                                                 activations_sample, radii_2)
        return float(pr[0][0]), float(pr[1][0])


def main(argv=None):
    """(reference: evaluations/evaluator.py:28-61)"""
    from ..cli.sample import select_device

    parser = argparse.ArgumentParser()
    parser.add_argument("ref_batch", help="path to reference batch npz file")
    parser.add_argument("sample_batch", help="path to sample batch npz file")
    args = parser.parse_args(argv)

    evaluator = Evaluator(device=select_device())
    print("warming up...")
    evaluator.warmup()
    print("computing reference batch activations...")
    ref_acts = evaluator.read_activations(args.ref_batch)
    print("computing/reading reference batch statistics...")
    ref_stats, ref_stats_spatial = evaluator.read_statistics(args.ref_batch, ref_acts)
    print("computing sample batch activations...")
    sample_acts = evaluator.read_activations(args.sample_batch)
    print("computing/reading sample batch statistics...")
    sample_stats, sample_stats_spatial = evaluator.read_statistics(args.sample_batch,
                                                                   sample_acts)
    print("Computing evaluations...")
    print("Inception Score:", evaluator.compute_inception_score(sample_acts[0]))
    print("FID:", sample_stats.frechet_distance(ref_stats))
    print("sFID:", sample_stats_spatial.frechet_distance(ref_stats_spatial))
    prec, recall = evaluator.compute_prec_recall(ref_acts[0], sample_acts[0])
    print("Precision:", prec)
    print("Recall:", recall)


if __name__ == "__main__":
    main()
