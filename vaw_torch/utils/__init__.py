"""Configuration, run artifacts and the metric logger."""

from .config import (
    TrainConfig,
    add_sample_args,
    add_train_args,
    config_from_args,
    str2bool,
)
from .logging import (
    generate_logdir,
    make_grid,
    save_eval_npz,
    save_grid_png,
    save_metrics_to_csv,
    snapshot_sources,
)

__all__ = [
    "TrainConfig", "add_train_args", "add_sample_args", "config_from_args",
    "str2bool", "generate_logdir", "snapshot_sources", "make_grid",
    "save_grid_png", "save_metrics_to_csv", "save_eval_npz",
]
