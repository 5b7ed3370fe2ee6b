"""Backbones of the port: the DiT and U-ViT families so far."""

from .registry import build_model, cast_for_compute

__all__ = ["build_model", "cast_for_compute"]
