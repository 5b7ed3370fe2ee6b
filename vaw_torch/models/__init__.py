"""Backbones of the port: the DiT, U-ViT, ViT, MM-DiT and ADM UNet families."""

from .registry import build_model, cast_for_compute

__all__ = ["build_model", "cast_for_compute"]
