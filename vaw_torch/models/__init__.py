"""Backbones of the port: the DiT, U-ViT and ADM UNet families so far."""

from .registry import build_model, cast_for_compute

__all__ = ["build_model", "cast_for_compute"]
