"""Checkpoint loading (training comes in a later slice)."""

from .checkpoint import load_checkpoint

__all__ = ["load_checkpoint"]
