"""Configuration."""

from .config import TrainConfig, add_sample_args, config_from_args, str2bool

__all__ = ["TrainConfig", "add_sample_args", "config_from_args", "str2bool"]
