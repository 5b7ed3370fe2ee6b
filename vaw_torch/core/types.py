"""Model-output / variance / loss enums
(reference: tools/gaussian_diffusion.py:21-56)."""

from __future__ import annotations

import enum

__all__ = ["ModelMeanType", "ModelVarType", "LossType"]


class ModelMeanType(enum.Enum):
    """What the model predicts."""

    PREVIOUS_X = enum.auto()  # x_{t-1}
    START_X = enum.auto()  # x_0
    EPSILON = enum.auto()  # noise
    VELOCITY = enum.auto()  # alpha_t * eps - sigma_t * x_0
    VECTOR = enum.auto()  # flow-matching vector d_alpha_t * x_0 + d_sigma_t * eps
    SCORE = enum.auto()  # score function


class ModelVarType(enum.Enum):
    """How the model's output variance is produced."""

    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)
