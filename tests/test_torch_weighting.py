"""Parity of the port's MSE loss weighting (vaw_torch/core/weighting.py)
with vaw_tpu.core.weighting.compute_mse_loss_weight: every weight_type x
mean_type cell, the snr == 0 guard, and the ValueError of invalid cells.

Tolerance: rtol 1e-6, atol 1e-7 (the same f32 arithmetic on both sides;
inf and NaN before the guard are replaced by 1 on both).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.core.types import ModelMeanType as TorchMeanType
from vaw_torch.core.weighting import compute_mse_loss_weight as torch_weight
from vaw_tpu.core import ModelMeanType as JaxMeanType
from vaw_tpu.core import compute_mse_loss_weight as jax_weight

WEIGHT_TYPES = ["constant", "lambda", "debias", "p2", "min_debias",
                "max_debias", "min_snr_5", "max_snr_1", "min_snr_0.5",
                "trunc_snr", "snr", "inv_snr", "bogus"]
MEAN_TYPES = ["EPSILON", "START_X", "VECTOR", "VELOCITY", "PREVIOUS_X"]

# alpha = 0 (snr == 0, the guarded entry) through alpha near 1.
ALPHA = np.array([0.0, 0.05, 0.3, 0.7, 0.95, 0.9999], np.float32)
SIGMA = np.sqrt(1.0 - ALPHA.astype(np.float64) ** 2).astype(np.float32)
T = np.arange(len(ALPHA), dtype=np.int32)


@pytest.mark.parametrize("weight_type", WEIGHT_TYPES)
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_every_cell_matches_jax(mean_type, weight_type):
    kw = dict(p2_k=1.5, p2_gamma=0.7)
    try:
        want = np.asarray(jax_weight(JaxMeanType[mean_type], weight_type,
                                     jnp.asarray(T), jnp.asarray(ALPHA),
                                     jnp.asarray(SIGMA), **kw))
    except ValueError:
        with pytest.raises(ValueError, match="Invalid weight_type"):
            torch_weight(TorchMeanType[mean_type], weight_type,
                         torch.from_numpy(T), torch.from_numpy(ALPHA),
                         torch.from_numpy(SIGMA), **kw)
        return
    got = torch_weight(TorchMeanType[mean_type], weight_type,
                       torch.from_numpy(T), torch.from_numpy(ALPHA),
                       torch.from_numpy(SIGMA), **kw)
    assert got.dtype == torch.float32 and got.shape == T.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_snr_zero_guard_gives_one():
    got = torch_weight(TorchMeanType.START_X, "inv_snr", torch.from_numpy(T),
                       torch.from_numpy(ALPHA), torch.from_numpy(SIGMA))
    assert got[0].item() == 1.0
