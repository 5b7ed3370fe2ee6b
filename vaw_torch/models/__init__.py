"""Backbones of the port: the DiT family so far."""

from .registry import build_model

__all__ = ["build_model"]
