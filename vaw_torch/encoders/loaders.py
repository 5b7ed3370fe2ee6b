"""Frozen-teacher loading: spec parsing, local weight discovery, and the
timm/CLIP -> port conversion with the per-family checkpoint fixups
(counterpart of vaw_tpu/encoders/loaders.py; reference: tools/encoders.py).

Weights must already be on the machine, at
``$VAW_ENCODER_DIR/{family}-vit-{size}.{safetensors,pth,pt,bin}`` (default
directory ``pretrained/encoders``); nothing is downloaded. ``.pth``, ``.pt``
and ``.bin`` files are read through ``torch.load(weights_only=True)``; a
``.safetensors`` file only where the safetensors package imports. The fixups
are the reference's: MoCo-v3 strips its ``module.base_encoder.`` prefix
(encoders.py:13-36), MAE and I-JEPA unwrap their checkpoint dicts
(encoders.py:185-257). The checkpoint's position table is resampled to the
token grid the teacher runs at, with the numpy copy of torch's antialiased
bicubic kernel that timm's ``resample_abs_pos_embed`` reaches.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.vae import _to_numpy, load_weights_file
from .vit_backbone import make_teacher

__all__ = ["load_encoders", "convert_timm_vit", "convert_clip_vit",
           "find_encoder_weights", "resample_pos_embed", "runtime_image_size"]


def find_encoder_weights(family: str, size: str) -> Optional[str]:
    base = os.environ.get("VAW_ENCODER_DIR", "pretrained/encoders")
    for ext in (".safetensors", ".pth", ".pt", ".bin"):
        p = os.path.join(base, f"{family}-vit-{size}{ext}")
        if os.path.exists(p):
            return p
    return None


def _load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """The checkpoint's tensors as numpy arrays, unwrapped and with the DDP
    prefixes stripped (vaw_tpu/encoders/loaders.py:38-62)."""
    sd = load_weights_file(path)
    if path.endswith(".safetensors"):
        return sd
    for key in ("state_dict", "model", "target_encoder", "encoder"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    out = {}
    for k, v in sd.items():
        for prefix in ("module.base_encoder.", "module.", "base_encoder."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = _to_numpy(v)
    return out


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic kernel with a = -0.5, the filter torch's antialiased
    bicubic path uses."""
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a, 0.0))


def _resize_bicubic_axis(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One axis of torch F.interpolate(mode='bicubic', align_corners=False,
    antialias=True) in float64: half-pixel centres, the kernel stretched by
    in/out when downscaling, the window cut at the borders and its weights
    renormalised (vaw_tpu/encoders/loaders.py:81-106)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    scale = in_size / out_size
    kscale = max(scale, 1.0)
    support = 2.0 * kscale
    center = scale * (np.arange(out_size) + 0.5)
    lo = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    hi = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size)
    taps = int(np.ceil(support)) * 2 + 1
    idxs = lo[:, None] + np.arange(taps)[None, :]
    weights = _cubic_kernel((idxs - center[:, None] + 0.5) / kscale)
    weights = np.where(idxs < hi[:, None], weights, 0.0)
    weights = weights / weights.sum(axis=1, keepdims=True)
    idxs = np.clip(idxs, 0, in_size - 1)  # zero-weight taps only
    moved = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    out = np.einsum("ok,ok...->o...", weights, moved[idxs])
    return np.moveaxis(out, 0, axis)


def resample_pos_embed(pos: np.ndarray, target_grid: int,
                       num_prefix_tokens: int = 1) -> np.ndarray:
    """Bicubically resample an absolute position table [1, P + T, D] (or
    [P + T, D]) to a target_grid x target_grid grid, keeping the P prefix
    rows: timm's resample_abs_pos_embed, in numpy
    (vaw_tpu/encoders/loaders.py:109-127)."""
    pos = np.asarray(pos)
    squeeze = pos.ndim == 3
    tab = pos[0] if squeeze else pos
    prefix, grid_part = tab[:num_prefix_tokens], tab[num_prefix_tokens:]
    src = int(round(len(grid_part) ** 0.5))
    if src * src != len(grid_part):
        raise ValueError(f"pos_embed grid is not square: {len(grid_part)} tokens")
    if src != target_grid:
        g = grid_part.reshape(src, src, -1)
        g = _resize_bicubic_axis(g, target_grid, 0)
        g = _resize_bicubic_axis(g, target_grid, 1)
        grid_part = g.reshape(target_grid * target_grid, -1)
    out = np.concatenate([prefix, grid_part]).astype(pos.dtype)
    return out[None] if squeeze else out


def _tensors(params: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()}


def convert_timm_vit(sd: Mapping, depth: int, layer_scale: bool = False,
                     use_cls_token: bool = True, pre_norm: bool = False,
                     final_norm: bool = True, target_grid: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """A timm/DINO/MAE-style ViT state dict (numpy arrays) -> the state dict
    of the port's FeatureViT, taking what vaw_tpu/encoders/loaders.py:130-195
    takes: the patch conv (its bias unless `pre_norm`), the cls token where
    `use_cls_token`, the position table (resampled to `target_grid` when
    given), register tokens and ln_pre where present, `depth` blocks with
    their layer scales (``ls1.gamma`` or ``gamma_1``) where `layer_scale`,
    and the final norm where `final_norm`."""
    params: Dict[str, np.ndarray] = {"patch_embed.proj.weight": sd["patch_embed.proj.weight"]}
    if "patch_embed.proj.bias" in sd and not pre_norm:
        params["patch_embed.proj.bias"] = sd["patch_embed.proj.bias"]
    if use_cls_token and "cls_token" in sd:
        params["cls_token"] = sd["cls_token"]
    if "pos_embed" in sd:
        pos = sd["pos_embed"]
        if target_grid is not None:
            pos = resample_pos_embed(pos, target_grid,
                                     num_prefix_tokens=1 if use_cls_token else 0)
        params["pos_embed"] = pos
    if "register_tokens" in sd:
        params["register_tokens"] = sd["register_tokens"]
    if pre_norm and "ln_pre.weight" in sd:
        params["ln_pre.weight"] = sd["ln_pre.weight"]
        params["ln_pre.bias"] = sd["ln_pre.bias"]
    for i in range(depth):
        p = f"blocks.{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                params[f"{p}.{name}.{leaf}"] = sd[f"{p}.{name}.{leaf}"]
        if layer_scale:
            for j in (1, 2):
                key = f"{p}.ls{j}.gamma"
                params[f"{p}.ls{j}"] = sd[key] if key in sd else sd[f"{p}.gamma_{j}"]
    if final_norm and "norm.weight" in sd:
        params["norm.weight"] = sd["norm.weight"]
        params["norm.bias"] = sd["norm.bias"]
    return _tensors(params)


def convert_clip_vit(sd: Mapping, depth: int, target_grid: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """A CLIP visual-tower state dict (numpy arrays; an optional ``visual.``
    prefix) -> the port's FeatureViT state dict
    (vaw_tpu/encoders/loaders.py:198-241; reference:
    encoders/clip_vit.py:159-230): the bias-free ``conv1``, the
    ``class_embedding``, the ``positional_embedding`` (resampled to
    `target_grid` when given), ``ln_pre`` and the residual blocks;
    ``ln_post`` and ``proj`` are dropped, as the reference wrapper never
    applies them."""
    sd = {k[len("visual."):] if k.startswith("visual.") else k: v for k, v in sd.items()}
    pos = np.asarray(sd["positional_embedding"])[None]
    if target_grid is not None:
        pos = resample_pos_embed(pos, target_grid, num_prefix_tokens=1)
    params = {
        "patch_embed.proj.weight": sd["conv1.weight"],
        "cls_token": np.asarray(sd["class_embedding"]).reshape(1, 1, -1),
        "pos_embed": pos,
        "ln_pre.weight": sd["ln_pre.weight"], "ln_pre.bias": sd["ln_pre.bias"],
    }
    names = {"ln_1": "norm1", "ln_2": "norm2", "mlp.c_fc": "mlp.fc1",
             "mlp.c_proj": "mlp.fc2", "attn.out_proj": "attn.proj"}
    for i in range(depth):
        src, dst = f"transformer.resblocks.{i}", f"blocks.{i}"
        for theirs, ours in names.items():
            for leaf in ("weight", "bias"):
                params[f"{dst}.{ours}.{leaf}"] = sd[f"{src}.{theirs}.{leaf}"]
        params[f"{dst}.attn.qkv.weight"] = sd[f"{src}.attn.in_proj_weight"]
        params[f"{dst}.attn.qkv.bias"] = sd[f"{src}.attn.in_proj_bias"]
    return _tensors(params)


def runtime_image_size(family: str, image_size: int) -> int:
    """The pixel size a teacher sees after the align glue's preprocessing
    (reference: tools/align_utils.py:19-40): clip, dinov2 and jepa inputs
    are resized to 224 * (resolution // 256); mae, mocov3 and dinov1 take
    the raw pixels."""
    if family in ("clip", "dinov2", "dinov2reg", "jepa"):
        return 224 * max(image_size // 256, 1)
    return image_size


def _parse_spec(spec: str) -> Tuple[str, str, str]:
    """'dinov2-vit-b' -> (family, arch, size) (reference:
    tools/encoders.py:56-66)."""
    parts = spec.split("-")
    if len(parts) != 3:
        raise ValueError(f"bad encoder spec {spec!r}")
    return parts[0], parts[1], parts[2]


def load_encoders(enc_type: str, image_size: int = 224,
                  dtype: torch.dtype = torch.float32, device="cuda"):
    """The frozen teachers of a comma-separated spec list, for pixels of
    `image_size`: (encoders, architectures, families), the reference's
    tuple (tools/encoders.py:56-94). Each encoder is the FeatureViT itself
    on `device`, in eval mode with gradients off, mapping preprocessed NHWC
    pixels to token features; its position table is the checkpoint's,
    resampled to the grid of ``runtime_image_size``."""
    encoders: List[torch.nn.Module] = []
    architectures: List[str] = []
    families: List[str] = []
    for spec in enc_type.split(","):
        family, arch, size = _parse_spec(spec.strip())
        eff = runtime_image_size(family, image_size)
        model = make_teacher(family, size, eff, dtype)
        path = find_encoder_weights(family, size)
        if path is None:
            raise FileNotFoundError(
                f"weights for {spec} not found; place them at "
                f"$VAW_ENCODER_DIR/{family}-vit-{size}.(safetensors|pth)")
        sd = _load_torch_state(path)
        grid = eff // model.patch_size
        if family == "clip":
            params = convert_clip_vit(sd, depth=model.depth, target_grid=grid)
        else:
            params = convert_timm_vit(
                sd, depth=model.depth, layer_scale=model.blocks[0].ls1 is not None,
                use_cls_token=model.cls_token is not None,
                pre_norm=model.ln_pre is not None, final_norm=model.norm is not None,
                target_grid=grid)
        model.load_state_dict(params, strict=True)
        encoders.append(model.to(device).eval().requires_grad_(False))
        architectures.append(arch)
        families.append(family)
    return encoders, architectures, families
