"""InceptionV3 feature backend for FID, sFID and IS (counterpart of
vaw_tpu/evals/inception.py; reference: evaluations/evaluator.py:21-25,
574-620).

The features are those of OpenAI's frozen TF1 InceptionV3 graph:
pool_3 (2048 values an image) and the first 7 channels of mixed_6/conv
(17x17x7), flattened in NHWC order, and the softmax over pool_3 @ W of the
graph's logits MatMul (no bias). ``InceptionV3GraphFeatures`` evaluates
that graph with ``tf_graph.GraphDefFunction`` on one device, read by
``graphdef.py`` with no TensorFlow.

The graph file is looked up on the machine only (``find_inception_pb``):
nothing is downloaded. ``make_inception_backend`` knows one backend,
``torch`` (``auto`` is the same). The JAX package's ``jax`` and ``tf``
backends (XLA, and a TF1 session on the host) belong to vaw_tpu and are
refused by name; there is no fallback to another backend, so the features
are always the device's.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .fid import full_f32
from .graphdef import load_graph_def
from .tf_graph import GraphDefFunction

__all__ = ["InceptionV3GraphFeatures", "make_inception_backend", "find_inception_pb",
           "FID_POOL_NAME", "FID_SPATIAL_NAME"]

FID_POOL_NAME = "pool_3:0"
FID_SPATIAL_NAME = "mixed_6/conv:0"


def find_inception_pb() -> Optional[str]:
    """$VAW_INCEPTION_PB, or classify_image_graph_def.pb in the working
    directory, evaluations/, reference_batches/ or /tmp."""
    candidates = [
        os.environ.get("VAW_INCEPTION_PB", ""),
        "classify_image_graph_def.pb",
        os.path.join("evaluations", "classify_image_graph_def.pb"),
        os.path.join("reference_batches", "classify_image_graph_def.pb"),
        "/tmp/classify_image_graph_def.pb",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


class InceptionV3GraphFeatures:
    """The frozen graph's pool_3 and spatial features and softmax head on
    `device` (reference: evaluations/evaluator.py:123-141, 585-620)."""

    def __init__(self, pb_path: Optional[str] = None, batch_size: int = 64,
                 softmax_batch_size: int = 512, device="cuda"):
        pb_path = pb_path or find_inception_pb()
        if pb_path is None:
            raise FileNotFoundError(
                "InceptionV3 frozen graph not found; set VAW_INCEPTION_PB or place "
                "classify_image_graph_def.pb in ./evaluations/")
        self.batch_size = batch_size
        self.softmax_batch_size = softmax_batch_size
        self.device = torch.device(device)
        self.graph = GraphDefFunction(load_graph_def(pb_path), feeds=["ExpandDims:0"],
                                      fetches=[FID_POOL_NAME, FID_SPATIAL_NAME],
                                      device=self.device)
        # The softmax head's W, read through Identity and CheckNumerics
        # (reference: evaluations/evaluator.py:613-620).
        nodes = self.graph.nodes
        name = nodes["softmax/logits/MatMul"].input[1].split(":")[0]
        while nodes[name].op in ("Identity", "CheckNumerics"):
            name = nodes[name].input[0].split(":")[0]
        self.softmax_w = self.graph.const_tensor(name).float()

    @torch.no_grad()
    def features_tensor(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images in [0, 255] (numpy or a tensor) -> (pool [N, 2048],
        spatial [N, 17*17*7]) as f32 tensors on the device, batch_size
        images at a time."""
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.array(batch))  # a writable copy
        x = batch.to(self.device, torch.float32)
        pools, spatials = [], []
        for i in range(0, x.shape[0], self.batch_size):
            pool, spatial = self.graph(x[i: i + self.batch_size])
            pools.append(pool.reshape(pool.shape[0], -1))
            # Only the first 7 spatial channels feed sFID
            # (reference: evaluations/evaluator.py:600-601).
            spatials.append(spatial[..., :7].reshape(spatial.shape[0], -1))
        return torch.cat(pools), torch.cat(spatials)

    def features(self, batch) -> Tuple[np.ndarray, np.ndarray]:
        """features_tensor as host numpy arrays."""
        pool, spatial = self.features_tensor(batch)
        return pool.cpu().numpy(), spatial.cpu().numpy()

    @torch.no_grad()
    def softmax_probs(self, pool_features: np.ndarray) -> np.ndarray:
        out = []
        with full_f32():
            for i in range(0, len(pool_features), self.softmax_batch_size):
                chunk = torch.as_tensor(
                    np.asarray(pool_features[i: i + self.softmax_batch_size], np.float32),
                    device=self.device)
                out.append(torch.softmax(chunk @ self.softmax_w, dim=-1).cpu().numpy())
        return np.concatenate(out, axis=0)


def make_inception_backend(backend: str = "auto", pb_path: Optional[str] = None,
                           batch_size: int = 64, softmax_batch_size: int = 512,
                           device="cuda") -> InceptionV3GraphFeatures:
    """The Inception backend: 'torch' (or 'auto') is the frozen graph on
    `device`; $VAW_INCEPTION_BACKEND overrides `backend`."""
    backend = os.environ.get("VAW_INCEPTION_BACKEND", backend)
    if backend in ("auto", "torch"):
        return InceptionV3GraphFeatures(pb_path=pb_path, batch_size=batch_size,
                                        softmax_batch_size=softmax_batch_size,
                                        device=device)
    if backend in ("jax", "tf"):
        raise ValueError(
            f"inception backend {backend!r} belongs to the JAX package (vaw_tpu: "
            "the graph compiled by XLA, or a TF1 session on the host); this port "
            "runs the frozen graph itself on its device, backend 'torch' or 'auto'")
    raise ValueError(f"unknown inception backend {backend!r}")
