"""Run artifacts: logdir layout, config snapshot and sample grids
(counterpart of vaw_tpu/utils/logging.py; reference: tools/utils.py:33-60,
123-165).

    {logdir}/{timestamp}/config.yaml
    {logdir}/{timestamp}/code/**            (source snapshot of vaw_torch)
    {logdir}/{timestamp}/sample/{step}.png  (grids)
    {logdir}/{timestamp}/generate_sample/{dataset}_{H}x{W}_samples.npz
    {logdir}/{timestamp}/metrics.csv        (one row per evaluation)

config.yaml is written without PyYAML: one ``key: value`` line per field,
each value in JSON, which YAML reads as it is.
"""

from __future__ import annotations

import csv
import json
import math
import os
import shutil
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["generate_logdir", "snapshot_sources", "make_grid", "save_grid_png",
           "save_metrics_to_csv", "save_eval_npz"]

_PACKAGE = Path(__file__).resolve().parents[1]


def snapshot_sources(logdir: str):
    """Copy the port's own sources, CUDA ones included, into {logdir}/code
    (reference: tools/utils.py:33-49)."""
    dst_root = Path(logdir) / "code"
    for pattern in ("*.py", "*.cu", "*.cuh", "*.h"):
        for src in _PACKAGE.rglob(pattern):
            if "__pycache__" in src.parts:
                continue
            dst = dst_root / src.relative_to(_PACKAGE.parent)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src, dst)


def _yaml_value(v) -> str:
    if isinstance(v, tuple):
        v = list(v)
    return json.dumps(v)


def generate_logdir(cfg, snapshot: bool = True) -> str:
    """Create {logdir}/{timestamp}, snapshot the sources and write
    config.yaml (reference: tools/utils.py:51-60). Sets cfg.logdir to the
    new directory, as the reference does with args.logdir."""
    stamp = datetime.fromtimestamp(int(time.time())).strftime("%Y%m%d-%H%M%S")
    logdir = os.path.join(cfg.logdir, stamp)
    cfg.logdir = logdir
    os.makedirs(logdir, exist_ok=True)
    if snapshot:
        snapshot_sources(logdir)
    with open(os.path.join(logdir, "config.yaml"), "w") as f:
        for k, v in cfg.to_dict().items():
            f.write(f"{k}: {_yaml_value(v)}\n")
    return logdir


def make_grid(images: np.ndarray, nrow: Optional[int] = None,
              pad: int = 2, pad_value: int = 128) -> np.ndarray:
    """uint8 NHWC -> one uint8 HWC grid (torchvision make_grid equivalent,
    reference: tools/utils.py:140-146)."""
    n, h, w, c = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    grid = np.full((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   pad_value, np.uint8)
    for i in range(n):
        r, cc = divmod(i, nrow)
        y = r * (h + pad) + pad
        x = cc * (w + pad) + pad
        grid[y: y + h, x: x + w] = images[i]
    return grid


def save_grid_png(logdir: str, step: int, images: np.ndarray) -> str:
    """{logdir}/sample/{step}.png; images with 4 channels (latents, when no
    VAE decoder is loaded) keep their first three."""
    from PIL import Image

    sample_dir = os.path.join(logdir, "sample")
    os.makedirs(sample_dir, exist_ok=True)
    path = os.path.join(sample_dir, f"{step}.png")
    grid = make_grid(images)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    elif grid.shape[-1] > 3:
        grid = grid[..., :3]
    Image.fromarray(grid).save(path)
    return path


def save_metrics_to_csv(logdir: str, metrics: Dict, step: int):
    """Append one row per evaluation to {logdir}/metrics.csv, numbers to two
    decimals, with a header first (reference: tools/utils.py:190-201;
    vaw_tpu/utils/logging.py:96-108)."""
    path = os.path.join(logdir, "metrics.csv")
    exists = os.path.isfile(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(["Step"] + list(metrics.keys()))
        w.writerow([step] + [f"{v:.2f}" if isinstance(v, (int, float)) else v
                             for v in metrics.values()])


def save_eval_npz(logdir: str, dataset: str, samples: np.ndarray,
                  labels: Optional[np.ndarray] = None) -> str:
    """The evaluation's samples (and labels) as
    {logdir}/generate_sample/{dataset}_{H}x{W}_samples.npz
    (reference: tools/utils.py:148-161; vaw_tpu/utils/logging.py:143-155)."""
    sample_dir = os.path.join(logdir, "generate_sample")
    os.makedirs(sample_dir, exist_ok=True)
    shape_str = "x".join(str(x) for x in samples.shape[1:3])
    path = os.path.join(sample_dir, f"{dataset}_{shape_str}_samples.npz")
    if labels is not None:
        np.savez(path, samples, labels)
    else:
        np.savez(path, samples)
    return path
