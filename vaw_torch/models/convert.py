"""Flax DiT params -> the port's DiT state dict.

Inverse of the DiT rules of vaw_tpu/models/convert.py (``_DIT_RULES``,
reference torch names -> Flax paths). The port's DiT uses the reference
names, so its state dict is exactly what those rules map from:

- Flax ``Dense`` kernel [in, out] -> torch ``Linear`` weight [out, in];
- Flax ``Conv`` kernel HWIO -> torch ``Conv2d`` weight OIHW;
- embedding tables and biases carry over unchanged;
- the frozen sin-cos ``pos_embed`` is recomputed by the model, not stored.

The rules are copied here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["flax_dit_to_torch"]


def _t(w: np.ndarray) -> np.ndarray:
    """Flax Dense kernel [in, out] -> torch Linear weight [out, in]."""
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:
    """Flax Conv kernel HWIO -> torch Conv2d weight OIHW."""
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _same(w: np.ndarray) -> np.ndarray:
    return w


_BLOCK = r"DiTBlock_(\d+)/"
_DIT_RULES: Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]] = {
    r"PatchEmbed_0/Conv_0/kernel": ("x_embedder.proj.weight", _conv),
    r"PatchEmbed_0/Conv_0/bias": ("x_embedder.proj.bias", _same),
    r"TimestepEmbedder_0/Dense_0/kernel": ("t_embedder.mlp.0.weight", _t),
    r"TimestepEmbedder_0/Dense_0/bias": ("t_embedder.mlp.0.bias", _same),
    r"TimestepEmbedder_0/Dense_1/kernel": ("t_embedder.mlp.2.weight", _t),
    r"TimestepEmbedder_0/Dense_1/bias": ("t_embedder.mlp.2.bias", _same),
    r"LabelEmbedder_0/Embed_0/embedding": (
        "y_embedder.embedding_table.weight", _same),
    _BLOCK + r"Dense_0/kernel": (r"blocks.\1.adaLN_modulation.1.weight", _t),
    _BLOCK + r"Dense_0/bias": (r"blocks.\1.adaLN_modulation.1.bias", _same),
    _BLOCK + r"MultiHeadSelfAttention_0/Dense_0/kernel": (
        r"blocks.\1.attn.qkv.weight", _t),
    _BLOCK + r"MultiHeadSelfAttention_0/Dense_0/bias": (
        r"blocks.\1.attn.qkv.bias", _same),
    _BLOCK + r"MultiHeadSelfAttention_0/Dense_1/kernel": (
        r"blocks.\1.attn.proj.weight", _t),
    _BLOCK + r"MultiHeadSelfAttention_0/Dense_1/bias": (
        r"blocks.\1.attn.proj.bias", _same),
    _BLOCK + r"Mlp_0/Dense_0/kernel": (r"blocks.\1.mlp.fc1.weight", _t),
    _BLOCK + r"Mlp_0/Dense_0/bias": (r"blocks.\1.mlp.fc1.bias", _same),
    _BLOCK + r"Mlp_0/Dense_1/kernel": (r"blocks.\1.mlp.fc2.weight", _t),
    _BLOCK + r"Mlp_0/Dense_1/bias": (r"blocks.\1.mlp.fc2.bias", _same),
    r"FinalLayer_0/Dense_0/kernel": ("final_layer.adaLN_modulation.1.weight", _t),
    r"FinalLayer_0/Dense_0/bias": ("final_layer.adaLN_modulation.1.bias", _same),
    r"FinalLayer_0/Dense_1/kernel": ("final_layer.linear.weight", _t),
    r"FinalLayer_0/Dense_1/bias": ("final_layer.linear.bias", _same),
}
_TOP_REQUIRED = (
    "x_embedder.proj.weight", "x_embedder.proj.bias",
    "t_embedder.mlp.0.weight", "t_embedder.mlp.0.bias",
    "t_embedder.mlp.2.weight", "t_embedder.mlp.2.bias",
    "final_layer.adaLN_modulation.1.weight", "final_layer.adaLN_modulation.1.bias",
    "final_layer.linear.weight", "final_layer.linear.bias",
)
_BLOCK_REQUIRED = (
    "adaLN_modulation.1.weight", "adaLN_modulation.1.bias",
    "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
    "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias",
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def flax_dit_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax ``vaw_tpu.models.dit.DiT`` params (numpy leaves) -> the
    state dict of ``vaw_torch.models.dit.DiT``. Raises on any Flax leaf no
    rule matches (the REPA projector included) and on any tensor the port's
    DiT needs that the params lack."""
    compiled = [(re.compile(pat + r"\Z"), rule) for pat, rule in _DIT_RULES.items()]
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(params).items():
        for rx, (name_tpl, fn) in compiled:
            m = rx.match(path)
            if m is not None:
                out[m.expand(name_tpl)] = torch.from_numpy(np.array(fn(np.asarray(value))))
                break
        else:
            unmatched.append(path)
    if unmatched:
        raise ValueError(f"no conversion rule for {len(unmatched)} Flax params: "
                         f"{unmatched[:8]}{'...' if len(unmatched) > 8 else ''}")
    depth = 1 + max((int(k.split(".")[1]) for k in out if k.startswith("blocks.")),
                    default=-1)
    required = list(_TOP_REQUIRED) + [
        f"blocks.{i}.{n}" for i in range(depth) for n in _BLOCK_REQUIRED]
    missing = [k for k in required if k not in out]
    if depth == 0 or missing:
        raise ValueError(f"Flax params lack {len(missing) or 'all block'} DiT "
                         f"tensors: {missing[:8]}")
    return out
