"""Flax params (and a whole train state) -> the port's state dicts.

Inverse of the DiT, ViT, U-ViT, MM-DiT and UNet rules of
vaw_tpu/models/convert.py (``_DIT_RULES``, ``_VIT_RULES``, ``convert_uvit``,
``_MMDIT_RULES`` and ``convert_unet``, reference torch names -> Flax paths),
the REPA projectors of the DiT and MM-DiT included, and of the SD-VAE's
diffusers -> Flax rules (vaw_tpu/data/vae.py:91-140; ``flax_vae_to_torch``).
The port's models use the reference names, so their state dicts are
exactly what those rules map from:

- Flax ``Dense`` kernel [in, out] -> torch ``Linear`` weight [out, in];
- Flax ``Conv`` kernel HWIO -> torch ``Conv2d`` weight OIHW;
- Flax ``LayerNorm`` scale -> torch ``weight``;
- embedding tables, biases and the learned ``pos_embed`` of U-ViT and ViT
  carry over unchanged; the DiT's and MM-DiT's frozen sin-cos ``pos_embed``
  is recomputed by the model, not stored.

Two names are the port's own. ViT's qkv bias: the JAX module has one fused,
trainable [3D] bias ``ViTAttention_0/Dense_0/bias``, k part included, which
the reference's ``q_bias``/``v_bias`` cannot hold (``convert_vit`` fills the
k part with zeros); the port follows the JAX module and keeps it whole as
``blocks.{i}.attn.qkv.bias``. MM-DiT's class table, a JAX package extension
with no reference name, is ``label_embed.weight``.

The rules are copied here so the port imports nothing of the JAX package.
``flax_to_torch`` picks the family from the Flax tree (a UNet's tree also
needs the port's model, whose block order numbers its Flax scopes);
``flax_train_state_to_torch`` carries a train state across (params, EMA and
the optax Adam moments through the same rules, and the step counts), so
tests can start both packages from one state.

Trees of the JAX models' other forms convert too (``_canonical``): under
``use_checkpoint`` Flax names each rematted block ``Checkpoint<Block>_i``,
and the scanned DiT (``scan_blocks``) keeps its blocks under
``ScanBlocks/<Block>_0`` with a leading depth axis, which is unstacked
onto ``blocks.{i}``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["flax_dit_to_torch", "flax_vit_to_torch", "flax_uvit_to_torch",
           "flax_mmdit_to_torch", "flax_unet_to_torch", "flax_vae_to_torch",
           "flax_to_torch", "flax_train_state_to_torch"]


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
    # The REPA projector after block encoder_depth: the DiT scope's
    # Dense_0/1/2 (vaw_tpu/models/convert.py:148-155).
    **{rf"Dense_{i}/{leaf}": (f"projectors.{2 * i}.{name}", fn) for i in range(3)
       for leaf, name, fn in (("kernel", "weight", _t), ("bias", "bias", _same))},
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


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bf16 included (numpy keeps bf16 as ml_dtypes'
    bfloat16, which torch.from_numpy does not take; the f32 round trip is
    exact)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


_REMAT_PREFIX = "Checkpoint"
_SCAN_KEY = "ScanBlocks"


def _canonical(params: Mapping) -> Dict[str, Any]:
    """`params` with the rematted blocks' ``Checkpoint`` prefix dropped from
    the top-level scopes, and a scanned DiT's ``ScanBlocks/<Block>_0``
    leaves, stacked on a leading depth axis, unstacked into ``<Block>_i``
    (vaw_tpu/models/dit.py:193-219)."""
    out: Dict[str, Any] = {}
    for key, value in params.items():
        key = str(key)
        if key == _SCAN_KEY:
            (name, stacked), = value.items()
            kind = str(name).removeprefix(_REMAT_PREFIX).rsplit("_", 1)[0]
            flat = _flatten(stacked)
            depths = {np.shape(v)[0] for v in flat.values()}
            if len(depths) != 1:
                raise ValueError(f"{_SCAN_KEY} leaves disagree on the depth: {depths}")
            for i in range(depths.pop()):
                block: Dict[str, Any] = {}
                for path, leaf in flat.items():
                    node = block
                    *scopes, last = path.split("/")
                    for scope in scopes:
                        node = node.setdefault(scope, {})
                    node[last] = np.asarray(leaf)[i]
                out[f"{kind}_{i}"] = block
        else:
            out[key.removeprefix(_REMAT_PREFIX)] = value
    return out


def _apply_rules(params: Mapping, rules: Mapping) -> Dict[str, torch.Tensor]:
    """Every leaf of the canonical tree through the first of `rules`
    (regex over the Flax path -> (torch name template, transform)) that
    matches; raises on a leaf no rule matches."""
    compiled = [(re.compile(pat + r"\Z"), rule) for pat, rule in rules.items()]
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(_canonical(params)).items():
        for rx, (name_tpl, fn) in compiled:
            m = rx.match(path)
            if m is not None:
                out[m.expand(name_tpl)] = _to_torch(fn(np.asarray(value)))
                break
        else:
            unmatched.append(path)
    if unmatched:
        raise ValueError(f"no conversion rule for {len(unmatched)} Flax params: "
                         f"{unmatched[:8]}{'...' if len(unmatched) > 8 else ''}")
    return out


def _depth(out: Mapping, prefix: str) -> int:
    """1 + the largest block index among the names under `prefix`."""
    return 1 + max((int(k.split(".")[1]) for k in out if k.startswith(prefix)),
                   default=-1)


def flax_dit_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax ``vaw_tpu.models.dit.DiT`` params (numpy leaves), unrolled,
    rematted or scanned -> the state dict of ``vaw_torch.models.dit.DiT``
    (its REPA projector included). Raises on any Flax leaf no rule matches
    and on any tensor the port's DiT needs that the params lack."""
    out = _apply_rules(params, _DIT_RULES)
    depth = _depth(out, "blocks.")
    required = list(_TOP_REQUIRED) + [
        f"blocks.{i}.{n}" for i in range(depth) for n in _BLOCK_REQUIRED]
    missing = [k for k in required if k not in out]
    if depth == 0 or missing:
        raise ValueError(f"Flax params lack {len(missing) or 'all block'} DiT "
                         f"tensors: {missing[:8]}")
    return out


_VBLOCK = r"ViTBlock_(\d+)/"
_VIT_RULES: Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]] = {
    r"PatchEmbed_0/Conv_0/kernel": ("patch_embed.proj.weight", _conv),
    r"PatchEmbed_0/Conv_0/bias": ("patch_embed.proj.bias", _same),
    r"time_embedding/embedding": ("time_embedding.weight", _same),
    r"class_embedding/embedding": ("class_embedding.weight", _same),
    r"pos_embed": ("pos_embed", _same),
    r"RelativePositionBias_0/relative_position_bias_table": (
        "rel_pos_bias.relative_position_bias_table", _same),
    _VBLOCK + r"LayerNorm_0/scale": (r"blocks.\1.norm1.weight", _same),
    _VBLOCK + r"LayerNorm_0/bias": (r"blocks.\1.norm1.bias", _same),
    _VBLOCK + r"LayerNorm_1/scale": (r"blocks.\1.norm2.weight", _same),
    _VBLOCK + r"LayerNorm_1/bias": (r"blocks.\1.norm2.bias", _same),
    _VBLOCK + r"ViTAttention_0/Dense_0/kernel": (r"blocks.\1.attn.qkv.weight", _t),
    _VBLOCK + r"ViTAttention_0/Dense_0/bias": (r"blocks.\1.attn.qkv.bias", _same),
    _VBLOCK + r"ViTAttention_0/Dense_1/kernel": (r"blocks.\1.attn.proj.weight", _t),
    _VBLOCK + r"ViTAttention_0/Dense_1/bias": (r"blocks.\1.attn.proj.bias", _same),
    _VBLOCK + r"gamma_([12])": (r"blocks.\1.gamma_\2", _same),
    _VBLOCK + r"Mlp_0/Dense_0/kernel": (r"blocks.\1.mlp.fc1.weight", _t),
    _VBLOCK + r"Mlp_0/Dense_0/bias": (r"blocks.\1.mlp.fc1.bias", _same),
    _VBLOCK + r"Mlp_0/Dense_1/kernel": (r"blocks.\1.mlp.fc2.weight", _t),
    _VBLOCK + r"Mlp_0/Dense_1/bias": (r"blocks.\1.mlp.fc2.bias", _same),
    r"LayerNorm_0/scale": ("norm.weight", _same),
    r"LayerNorm_0/bias": ("norm.bias", _same),
    r"Dense_0/kernel": ("linear_projection.weight", _t),
    r"Dense_0/bias": ("linear_projection.bias", _same),
    r"to_pixel/kernel": ("to_pixel.weight", _conv),
    r"to_pixel/bias": ("to_pixel.bias", _same),
}
_VIT_TOP_REQUIRED = ("patch_embed.proj.weight", "patch_embed.proj.bias",
                     "time_embedding.weight", "linear_projection.weight",
                     "linear_projection.bias")
_VIT_BLOCK_REQUIRED = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                       "attn.qkv.weight", "attn.proj.weight", "attn.proj.bias",
                       "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
                       "mlp.fc2.bias")


def flax_vit_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax ``vaw_tpu.models.vit.ViT`` params (numpy leaves), unrolled
    or rematted (``CheckpointViTBlock_i``) -> the state dict of
    ``vaw_torch.models.vit.ViT``; the inverse of ``_VIT_RULES``
    (vaw_tpu/models/convert.py:177-216) but for the fused qkv bias, which
    stays whole (module docstring). Raises on any Flax leaf no rule
    matches and on any tensor every ViT needs that the params lack."""
    out = _apply_rules(params, _VIT_RULES)
    depth = _depth(out, "blocks.")
    required = list(_VIT_TOP_REQUIRED) + [
        f"blocks.{i}.{n}" for i in range(depth) for n in _VIT_BLOCK_REQUIRED]
    missing = [k for k in required if k not in out]
    if depth == 0 or missing:
        raise ValueError(f"Flax params lack {len(missing) or 'all block'} ViT "
                         f"tensors: {missing[:8]}")
    return out


def _stream_rules(flax_stream: str, torch_stream: str):
    f = rf"joint_(\d+)/{flax_stream}/"
    p = rf"joint_blocks.\1.{torch_stream}."
    rules = {
        f + "adaLN/kernel": (p + "adaLN_modulation.1.weight", _t),
        f + "adaLN/bias": (p + "adaLN_modulation.1.bias", _same),
        f + "qkv_proj/kernel": (p + "attn.qkv.weight", _t),
        f + "qkv_proj/bias": (p + "attn.qkv.bias", _same),
        f + "out_proj/kernel": (p + "attn.proj.weight", _t),
        f + "out_proj/bias": (p + "attn.proj.bias", _same),
        f + r"([qk])_norm/scale": (p + r"attn.ln_\2.weight", _same),
        f + r"([qk])_norm/bias": (p + r"attn.ln_\2.bias", _same),
        f + r"mlp/(fc[12])/kernel": (p + r"mlp.\2.weight", _t),
        f + r"mlp/(fc[12])/bias": (p + r"mlp.\2.bias", _same),
        f + r"mlp/(w[123])/kernel": (p + r"mlp.\2.weight", _t),
    }
    return rules


_MMDIT_RULES: Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]] = {
    r"x_embedder/Conv_0/kernel": ("x_embedder.proj.weight", _conv),
    r"x_embedder/Conv_0/bias": ("x_embedder.proj.bias", _same),
    r"t_embedder/Dense_0/kernel": ("t_embedder.mlp.0.weight", _t),
    r"t_embedder/Dense_0/bias": ("t_embedder.mlp.0.bias", _same),
    r"t_embedder/Dense_1/kernel": ("t_embedder.mlp.2.weight", _t),
    r"t_embedder/Dense_1/bias": ("t_embedder.mlp.2.bias", _same),
    r"y_embedder_fc1/kernel": ("y_embedder.mlp.0.weight", _t),
    r"y_embedder_fc1/bias": ("y_embedder.mlp.0.bias", _same),
    r"y_embedder_fc2/kernel": ("y_embedder.mlp.2.weight", _t),
    r"y_embedder_fc2/bias": ("y_embedder.mlp.2.bias", _same),
    r"label_embed/embedding": ("label_embed.weight", _same),
    r"context_embedder/kernel": ("context_embedder.weight", _t),
    r"context_embedder/bias": ("context_embedder.bias", _same),
    r"register": ("register", _same),
    r"final_adaLN/kernel": ("final_layer.adaLN_modulation.1.weight", _t),
    r"final_adaLN/bias": ("final_layer.adaLN_modulation.1.bias", _same),
    r"final_linear/kernel": ("final_layer.linear.weight", _t),
    r"final_linear/bias": ("final_layer.linear.bias", _same),
    # The REPA projectors (vaw_tpu/models/convert.py:597-602).
    r"projector_(\d+)_fc1/kernel": (r"projectors.\1.0.weight", _t),
    r"projector_(\d+)_fc1/bias": (r"projectors.\1.0.bias", _same),
    r"projector_(\d+)_fc2/kernel": (r"projectors.\1.2.weight", _t),
    r"projector_(\d+)_fc2/bias": (r"projectors.\1.2.bias", _same),
    r"projector_(\d+)_fc3/kernel": (r"projectors.\1.4.weight", _t),
    r"projector_(\d+)_fc3/bias": (r"projectors.\1.4.bias", _same),
    **_stream_rules("context", "context_block"),
    **_stream_rules("x", "x_block"),
}
_MMDIT_TOP_REQUIRED = ("x_embedder.proj.weight", "t_embedder.mlp.0.weight",
                       "final_layer.linear.weight")


def flax_mmdit_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax ``vaw_tpu.models.mmdit.MMDiT`` params (numpy leaves) ->
    the state dict of ``vaw_torch.models.mmdit.MMDiT``; the inverse of
    ``_MMDIT_RULES`` (vaw_tpu/models/convert.py:550-605). A rematted model
    names its blocks ``joint_i`` too; the REPA projectors ``projector_{j}_fc*``
    become ``projectors.{j}``. Raises on any Flax leaf no rule matches and
    on any tensor every MM-DiT needs that the params lack."""
    out = _apply_rules(params, _MMDIT_RULES)
    depth = _depth(out, "joint_blocks.")
    required = list(_MMDIT_TOP_REQUIRED) + [
        f"joint_blocks.{i}.{s}.{n}" for i in range(depth)
        for s in ("context_block", "x_block")
        for n in ("adaLN_modulation.1.weight", "attn.qkv.weight")]
    missing = [k for k in required if k not in out]
    if depth == 0 or missing:
        raise ValueError(f"Flax params lack {len(missing) or 'all block'} MM-DiT "
                         f"tensors: {missing[:8]}")
    return out


_UVIT_TOP: Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]] = {
    "PatchEmbed_0/Conv_0/kernel": ("patch_embed.proj.weight", _conv),
    "PatchEmbed_0/Conv_0/bias": ("patch_embed.proj.bias", _same),
    "Embed_0/embedding": ("label_emb.weight", _same),
    "pos_embed": ("pos_embed", _same),
    "LayerNorm_0/scale": ("norm.weight", _same),
    "LayerNorm_0/bias": ("norm.bias", _same),
    "final_layer/kernel": ("final_layer.weight", _conv),
    "final_layer/bias": ("final_layer.bias", _same),
}
_UVIT_BLOCK: Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]] = {
    "LayerNorm_0/scale": ("norm1.weight", _same),
    "LayerNorm_0/bias": ("norm1.bias", _same),
    "LayerNorm_1/scale": ("norm2.weight", _same),
    "LayerNorm_1/bias": ("norm2.bias", _same),
    "Mlp_0/Dense_0/kernel": ("mlp.fc1.weight", _t),
    "Mlp_0/Dense_0/bias": ("mlp.fc1.bias", _same),
    "Mlp_0/Dense_1/kernel": ("mlp.fc2.weight", _t),
    "Mlp_0/Dense_1/bias": ("mlp.fc2.bias", _same),
}
_UVIT_TOP_REQUIRED = ("patch_embed.proj.weight", "patch_embed.proj.bias",
                      "pos_embed", "norm.weight", "norm.bias",
                      "decoder_pred.weight", "decoder_pred.bias",
                      "final_layer.weight", "final_layer.bias")
_UVIT_BLOCK_REQUIRED = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                        "attn.qkv.weight", "attn.proj.weight", "attn.proj.bias",
                        "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
                        "mlp.fc2.bias")


def flax_uvit_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax ``vaw_tpu.models.uvit.UViT`` params (numpy leaves) -> the
    state dict of ``vaw_torch.models.uvit.UViT``; the inverse of
    ``convert_uvit`` (vaw_tpu/models/convert.py:245-326).

    ``UViTBlock_i`` is ``in_blocks.i`` below the middle, ``mid_block`` at
    i = depth // 2 and ``out_blocks.(i - depth // 2 - 1)`` above it. Inside
    a skip block the skip Linear is ``Dense_0``, which shifts qkv and proj to
    ``Dense_1`` and ``Dense_2``. With ``mlp_time_embed`` the time MLP is the
    top-level ``Dense_0`` and ``Dense_1`` and the decoder ``Dense_2``;
    without it the decoder is ``Dense_0``. Raises on any Flax leaf no rule
    matches and on any tensor the port's U-ViT needs that the params lack.
    A rematted model's ``CheckpointUViTBlock_i`` are its ``UViTBlock_i``."""
    flat = _flatten(_canonical(params))
    blocks = sorted({int(m.group(1)) for m in (re.match(r"UViTBlock_(\d+)/", p)
                                                  for p in flat) if m})
    if blocks != list(range(len(blocks))) or len(blocks) % 2 == 0:
        raise ValueError(f"U-ViT params need blocks UViTBlock_0..2k, got {blocks}")
    half = len(blocks) // 2
    mlp_time_embed = any(p.startswith("Dense_2/") for p in flat)
    top = dict(_UVIT_TOP)
    for i, name in enumerate(["time_embed.0", "time_embed.2", "decoder_pred"]
                             if mlp_time_embed else ["decoder_pred"]):
        top[f"Dense_{i}/kernel"] = (f"{name}.weight", _t)
        top[f"Dense_{i}/bias"] = (f"{name}.bias", _same)

    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in flat.items():
        m = re.match(r"UViTBlock_(\d+)/(.*)\Z", path)
        if m is None:
            rule = top.get(path)
            prefix = ""
        else:
            i, field = int(m.group(1)), m.group(2)
            prefix = ("in_blocks.%d." % i if i < half else "mid_block." if i == half
                      else "out_blocks.%d." % (i - half - 1))
            skip = f"UViTBlock_{i}/Dense_2/kernel" in flat
            dense = ["skip_linear", "attn.qkv", "attn.proj"][0 if skip else 1:]
            rule = _UVIT_BLOCK.get(field)
            d = re.match(r"Dense_(\d+)/(kernel|bias)\Z", field)
            if d is not None and int(d.group(1)) < len(dense):
                kind = d.group(2)
                rule = (f"{dense[int(d.group(1))]}.{'weight' if kind == 'kernel' else 'bias'}",
                        _t if kind == "kernel" else _same)
        if rule is None:
            unmatched.append(path)
            continue
        name, fn = rule
        out[prefix + name] = _to_torch(fn(np.asarray(value)))
    if unmatched:
        raise ValueError(f"no conversion rule for {len(unmatched)} Flax params: "
                         f"{unmatched[:8]}{'...' if len(unmatched) > 8 else ''}")
    prefixes = ([f"in_blocks.{i}." for i in range(half)] + ["mid_block."]
                + [f"out_blocks.{i}." for i in range(half)])
    required = list(_UVIT_TOP_REQUIRED) + [
        p + n for p in prefixes for n in _UVIT_BLOCK_REQUIRED] + [
        f"out_blocks.{i}.skip_linear.{n}" for i in range(half)
        for n in ("weight", "bias")]
    if mlp_time_embed:
        required += [f"time_embed.{i}.{n}" for i in (0, 2) for n in ("weight", "bias")]
    missing = [k for k in required if k not in out]
    if missing:
        raise ValueError(f"Flax params lack {len(missing)} U-ViT tensors: "
                         f"{missing[:8]}")
    return out


def _norm(prefix: str) -> Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]]:
    return {"GroupNorm_0/scale": (f"{prefix}.weight", _same),
            "GroupNorm_0/bias": (f"{prefix}.bias", _same)}


def _dense(name: str, flax: str, fn=_t):
    return {f"{flax}/kernel": (f"{name}.weight", fn), f"{flax}/bias": (f"{name}.bias", _same)}


# Fields of each UNet block scope (vaw_tpu/models/convert.py:375-415 and
# :447-454, inverted). The port's qkv keeps the Flax Dense's (3, H, D) rows.
_UNET_BLOCK: Dict[str, Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]]] = {
    "ResBlock": {
        **{f"GroupNorm32_0/{k}": v for k, v in _norm("in_layers.0").items()},
        **_dense("in_layers.2", "Conv_0", _conv),
        **_dense("emb_layers.1", "Dense_0"),
        **{f"GroupNorm32_1/{k}": v for k, v in _norm("out_layers.0").items()},
        **_dense("out_layers.3", "Conv_1", _conv),
        **_dense("skip_connection", "Conv_2", _conv),
    },
    "AttentionBlock": {
        **{f"GroupNorm32_0/{k}": v for k, v in _norm("norm").items()},
        **_dense("qkv", "Dense_0"),
        **_dense("proj_out", "Dense_1"),
    },
    "Upsample": _dense("conv", "Conv_0", _conv),
    "Downsample": _dense("op", "Conv_0", _conv),
}
_UNET_TOP = {
    **_dense("input_blocks.0.0", "Conv_0", _conv),
    **_dense("time_embed.0", "Dense_0"),
    **_dense("time_embed.2", "Dense_1"),
    "Embed_0/embedding": ("label_emb.weight", _same),
    **{f"GroupNorm32_0/{k}": v for k, v in _norm("out.0").items()},
    **_dense("out.2", "Conv_1", _conv),
}


def flax_unet_to_torch(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """Nested Flax ``vaw_tpu.models.unet.UNetModel`` params (numpy leaves)
    -> the state dict of the port's ``model`` (a
    ``vaw_torch.models.unet.UNetModel`` of the same configuration); the
    inverse of ``_walk_unet_blocks`` (vaw_tpu/models/convert.py:418-458).

    Flax numbers ``ResBlock_N``, ``AttentionBlock_N``, ``Upsample_N`` and
    ``Downsample_N`` by kind in call order, which the tree alone does not
    tie to the block layout (two levels of one width look alike), so the
    block order comes from ``model.flax_scopes()``. At the top level the
    stem conv is ``Conv_0``, the final conv ``Conv_1``, the time MLP
    ``Dense_0``/``Dense_1`` and the label table ``Embed_0``. Raises on any
    Flax leaf no rule matches and on any tensor the model needs that the
    params lack. A rematted model's ``CheckpointResBlock_N`` and
    ``CheckpointAttentionBlock_N`` are its ``ResBlock_N`` and
    ``AttentionBlock_N``."""
    rules = dict(_UNET_TOP)
    for prefix, scope in model.flax_scopes().items():
        for field, (name, fn) in _UNET_BLOCK[scope.rsplit("_", 1)[0]].items():
            rules[f"{scope}/{field}"] = (f"{prefix}.{name}", fn)
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(_canonical(params)).items():
        if path not in rules:
            unmatched.append(path)
            continue
        name, fn = rules[path]
        out[name] = _to_torch(fn(np.asarray(value)))
    if unmatched:
        raise ValueError(f"no conversion rule for {len(unmatched)} Flax params: "
                         f"{unmatched[:8]}{'...' if len(unmatched) > 8 else ''}")
    missing = sorted(set(model.state_dict()) - set(out))
    if missing:
        raise ValueError(f"Flax params lack {len(missing)} UNet tensors: {missing[:8]}")
    return out


def _vae_resnet(flax: str, port: str):
    return {
        flax + r"GroupNorm_0/scale": (port + "norm1.weight", _same),
        flax + r"GroupNorm_0/bias": (port + "norm1.bias", _same),
        flax + r"GroupNorm_1/scale": (port + "norm2.weight", _same),
        flax + r"GroupNorm_1/bias": (port + "norm2.bias", _same),
        flax + r"(?P<c>conv1|conv2|conv_shortcut)/kernel": (port + r"\g<c>.weight", _conv),
        flax + r"(?P<c>conv1|conv2|conv_shortcut)/bias": (port + r"\g<c>.bias", _same),
    }


def _vae_rules(part: str, levels: str, level_flax: str, resample: str):
    """The rules of the encoder or decoder half of vaw_tpu/models/vae.py:
    ``{level_flax}_{i}_block_{j}`` -> ``{part}.{levels}.{i}.resnets.{j}``,
    ``{level_flax}_{i}_{sample}/conv`` -> ``{levels}.{i}.{resample}.0.conv``,
    ``mid_block_1/2`` and ``mid_attn`` -> the mid block's resnets and
    attention, ``GroupNorm_0`` -> ``conv_norm_out``."""
    f, p = f"{part}/", f"{part}."
    mid = p + "mid_block."
    attn = mid + "attentions.0."
    rules = {
        f + r"(?P<c>conv_in|conv_out)/kernel": (p + r"\g<c>.weight", _conv),
        f + r"(?P<c>conv_in|conv_out)/bias": (p + r"\g<c>.bias", _same),
        f + "GroupNorm_0/scale": (p + "conv_norm_out.weight", _same),
        f + "GroupNorm_0/bias": (p + "conv_norm_out.bias", _same),
        f + rf"{level_flax}_(\d+)_\w+sample/conv/kernel": (
            p + levels + rf".\1.{resample}.0.conv.weight", _conv),
        f + rf"{level_flax}_(\d+)_\w+sample/conv/bias": (
            p + levels + rf".\1.{resample}.0.conv.bias", _same),
        f + "mid_attn/GroupNorm_0/scale": (attn + "group_norm.weight", _same),
        f + "mid_attn/GroupNorm_0/bias": (attn + "group_norm.bias", _same),
        f + r"mid_attn/(?P<c>to_q|to_k|to_v)/kernel": (attn + r"\g<c>.weight", _t),
        f + r"mid_attn/(?P<c>to_q|to_k|to_v)/bias": (attn + r"\g<c>.bias", _same),
        f + "mid_attn/to_out/kernel": (attn + "to_out.0.weight", _t),
        f + "mid_attn/to_out/bias": (attn + "to_out.0.bias", _same),
        **_vae_resnet(f + rf"{level_flax}_(\d+)_block_(\d+)/",
                      p + levels + r".\1.resnets.\2."),
    }
    for i in (0, 1):
        rules.update(_vae_resnet(f + f"mid_block_{i + 1}/", mid + f"resnets.{i}."))
    return rules


_VAE_RULES: Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]] = {
    **_vae_rules("encoder", "down_blocks", "down", "downsamplers"),
    **_vae_rules("decoder", "up_blocks", "up", "upsamplers"),
    "encoder/quant_conv/kernel": ("quant_conv.weight", _conv),
    "encoder/quant_conv/bias": ("quant_conv.bias", _same),
    "decoder/post_quant_conv/kernel": ("post_quant_conv.weight", _conv),
    "decoder/post_quant_conv/bias": ("post_quant_conv.bias", _same),
}


def flax_vae_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax ``vaw_tpu.models.vae.AutoencoderKL`` params (numpy
    leaves, ``{"encoder": ..., "decoder": ...}``) -> the state dict of
    ``vaw_torch.models.vae.AutoencoderKL`` (diffusers' names). Raises on
    any Flax leaf no rule matches."""
    return _apply_rules(params, _VAE_RULES)


def flax_to_torch(params: Mapping, model=None) -> Dict[str, torch.Tensor]:
    """Flax params of a ported family -> the port's state dict, the family
    read from the tree (``DiTBlock_*``, ``ViTBlock_*``, ``UViTBlock_*``,
    ``joint_*`` or ``ResBlock_*`` scopes, rematted or scanned). A UNet's
    tree maps through the block order of `model`, the port's UNet of the
    same configuration (``flax_unet_to_torch``)."""
    scopes = {str(k).split("_")[0] for k in _canonical(params)}
    if "DiTBlock" in scopes:
        return flax_dit_to_torch(params)
    if "ViTBlock" in scopes:
        return flax_vit_to_torch(params)
    if "UViTBlock" in scopes:
        return flax_uvit_to_torch(params)
    if "joint" in scopes:
        return flax_mmdit_to_torch(params)
    if "ResBlock" in scopes:
        if model is None:
            raise ValueError("Flax params of a UNet: pass model=, the port's UNet of "
                             "the same configuration, for its block order")
        return flax_unet_to_torch(params, model)
    raise ValueError(f"Flax params of no ported family (top-level scopes "
                     f"{sorted(map(str, params))[:8]})")


def _optax_states(opt_state) -> List[Any]:
    """Every optax state object in a (nested) chain state, in order."""
    if isinstance(opt_state, (tuple, list)) and not hasattr(opt_state, "_fields"):
        return [s for sub in opt_state for s in _optax_states(sub)]
    return [opt_state]


def flax_train_state_to_torch(params: Mapping, ema: Mapping, opt_state,
                              model=None, resampler=None) -> Dict[str, Any]:
    """A JAX train state -> the port's: {"params", "ema", "opt": {"count",
    "mu", "nu"}}, the layout of vaw_torch.train.checkpoint, and
    {"resampler": {"loss_history", "loss_counts"}} when `resampler`, the
    JAX state's ``ResamplerState``, is given (vaw_tpu/train/state.py:29).

    The family's rules are picked from `params` (``flax_to_torch``; a UNet
    also needs `model`).
    `opt_state` is the optax.adamw (optionally clip-chained) state: its
    ScaleByAdamState mu and nu go through the same rules in their own dtype
    (bf16 moments stay bf16), its count becomes an int, and the schedule's
    count, which optax moves in step with it, must equal it. The objects
    are found by their NamedTuple fields, so nothing of optax is imported."""
    states = [(s, set(getattr(s, "_fields", ()))) for s in _optax_states(opt_state)]
    adam = [s for s, fields in states if {"count", "mu", "nu"} <= fields]
    if len(adam) != 1:
        raise ValueError(f"expected one ScaleByAdamState in opt_state, found {len(adam)}")
    (adam,) = adam
    count = int(np.asarray(adam.count))
    for s, fields in states:
        if fields == {"count"} and int(np.asarray(s.count)) != count:
            raise ValueError(f"schedule count {int(np.asarray(s.count))} != Adam "
                             f"count {count}: the port keeps one count")
    out = {
        "params": flax_to_torch(params, model),
        "ema": flax_to_torch(ema, model),
        "opt": {"count": count, "mu": flax_to_torch(adam.mu, model),
                "nu": flax_to_torch(adam.nu, model)},
    }
    if resampler is not None:
        out["resampler"] = {
            "loss_history": _to_torch(np.asarray(resampler.loss_history)),
            "loss_counts": _to_torch(np.asarray(resampler.loss_counts))}
    return out
