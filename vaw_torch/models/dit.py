"""DiT — adaLN-Zero diffusion transformer in PyTorch (counterpart of
vaw_tpu/models/dit.py; reference: models/dit.py:157-298).

Tokens stay [N, T, D]; images are NHWC at the interface. The model computes
in its ``compute_dtype`` (default: the dtype of its weights), casting f32
weights per call as the JAX model's ``dtype=cfg.compute_dtype`` does
(vaw_tpu/models/registry.py, dit.py:138); the residual stream stays in that
dtype, LayerNorm runs in f32 and the output is returned in f32, as in the
JAX package. Sizes S/B/L/XL match models/dit.py:361-382.

``use_checkpoint`` recomputes each block's activations in the backward
under ``remat_policy`` (``layers.remat_with_policy``; vaw_tpu/models/
dit.py:112-123). The JAX model's ``scan_blocks`` (a ``lax.scan`` over one
block with stacked params, vaw_tpu/models/dit.py:124, :193-219) has no
counterpart here: in eager PyTorch the scanned and the unrolled forms are
the same loop over the same ``blocks.{i}`` modules. The CLI accepts the
flag (``registry.build_model`` refuses it beside the REPA tap, as JAX
does), and a scanned Flax tree converts through
``convert.flax_dit_to_torch``. The REPA tap (ROADMAP A13) and sequence
parallelism (A16) of the JAX model come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    LabelEmbedder,
    Linear,
    Mlp,
    MultiHeadSelfAttention,
    PatchEmbed,
    TimestepEmbedder,
    check_remat_policy,
    get_2d_sincos_pos_embed,
    modulate,
    remat_with_policy,
)

__all__ = ["DiT", "DiT_S", "DiT_B", "DiT_L", "DiT_XL", "DiT_models"]


def _layer_norm(x):
    """Affine-free LayerNorm, eps 1e-6, computed in f32 and cast back
    (vaw_tpu/models/dit.py:54-61)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


class DiTBlock(nn.Module):
    """One adaLN-Zero block (reference: models/dit.py:118-137)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.attn = MultiHeadSelfAttention(hidden_size, num_heads, qkv_bias=True)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 6 * hidden_size))

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + gate_msa[:, None] * self.attn(
            modulate(_layer_norm(x), shift_msa, scale_msa))
        x = x + gate_mlp[:, None] * self.mlp(
            modulate(_layer_norm(x), shift_mlp, scale_mlp))
        return x


class FinalLayer(nn.Module):
    """adaLN + linear head (reference: models/dit.py:140-155)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.linear = Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 2 * hidden_size))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(_layer_norm(x), shift, scale))


class DiT(nn.Module):
    """forward(x [N, H, W, C], t [N], y [N] int) -> [N, H, W, C_out] f32.

    compute_dtype: the dtype of activations and products (bf16 for the
    trainer's f32 masters under --amp); None computes in the weights' dtype.
    use_checkpoint / remat_policy: remat of every block ("full" or "dots").
    """

    def __init__(self, image_size: int = 32, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 1000,
                 learn_sigma: bool = False, use_checkpoint: bool = False,
                 remat_policy: str = "full",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_checkpoint = use_checkpoint
        self.remat_policy = check_remat_policy(remat_policy)
        self.patch_size = patch_size
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.x_embedder = PatchEmbed(in_channels, patch_size, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = (
            LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
            if num_classes > 0 else None)
        # Frozen sin-cos table: recomputed, never stored in a checkpoint.
        pos = get_2d_sincos_pos_embed(hidden_size, image_size // patch_size)
        self.register_buffer("pos_embed", torch.from_numpy(pos), persistent=False)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels)
        self.initialize_weights()

    def initialize_weights(self):
        """Reference init (models/dit.py:199-241): xavier-uniform Linears,
        normal(0.02) label table and timestep MLP, and the adaLN-Zero
        modulation and output head at zero."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                nn.init.xavier_uniform_(module.weight)
                nn.init.zeros_(module.bias)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.zeros_(self.x_embedder.proj.bias)
        if self.y_embedder is not None:
            nn.init.normal_(self.y_embedder.embedding_table.weight, std=0.02)
        for i in (0, 2):
            nn.init.trunc_normal_(self.t_embedder.mlp[i].weight, std=0.02,
                                  a=-0.04, b=0.04)
        for head in [b.adaLN_modulation[1] for b in self.blocks] + [
                self.final_layer.adaLN_modulation[1], self.final_layer.linear]:
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)

    @property
    def has_null_label(self) -> bool:
        """Whether label num_classes, the unconditional label of CFG, exists."""
        return self.y_embedder is not None and self.y_embedder.has_null_row

    def forward(self, x, t, y=None, train: bool = False, force_drop_ids=None,
                generator: Optional[torch.Generator] = None):
        """train turns on label dropout (drawn from `generator`);
        force_drop_ids (1 = drop to the null label) replaces the draw
        (vaw_tpu/models/dit.py:132-158)."""
        dtype = self.compute_dtype or self.x_embedder.proj.weight.dtype
        x = self.x_embedder(x.to(dtype)) + self.pos_embed.to(dtype)[None]
        c = self.t_embedder(t, dtype)
        if self.y_embedder is not None:
            if y is None:
                raise ValueError("a class-conditional DiT needs labels y")
            c = c + self.y_embedder(y, train, force_drop_ids, generator).to(dtype)
        for block in self.blocks:
            run = (remat_with_policy(block, self.remat_policy)
                   if self.use_checkpoint else block)
            x = run(x, c)
        x = self.final_layer(x, c)
        return self._unpatchify(x).float()

    def forward_with_cfg(self, x, t, y, cfg_scale: float = 1.0):
        """Batched-uncond CFG forward with the reference's 3-channel quirk
        (reference: models/dit.py:282-298; vaw_tpu/models/dit.py:221-233):
        the first half of `x` runs twice, against the labels of both halves
        of `y`, guidance applies to the first 3 output channels only, and
        the rest pass through."""
        half = x[: x.shape[0] // 2]
        out = self(torch.cat([half, half]), t, y)
        eps, rest = out[..., :3], out[..., 3:]
        cond_eps, uncond_eps = eps.chunk(2)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=-1)

    def _unpatchify(self, x):
        """[N, T, p*p*C] -> NHWC [N, H, W, C] (reference: models/dit.py:243-256)."""
        n, t, _ = x.shape
        p = self.patch_size
        w = int(t ** 0.5)
        h = t // w
        if h * w != t:
            raise ValueError(f"{t} tokens do not form a square grid")
        x = x.reshape(n, h, w, p, p, self.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h * p, w * p, self.out_channels)


def _make_dit(hidden_size, depth, num_heads):
    def ctor(image_size, patch_size, in_channels, class_dropout_prob,
             num_classes, learn_sigma, **kwargs):
        return DiT(
            image_size=image_size, patch_size=patch_size or 2,
            in_channels=in_channels, hidden_size=hidden_size, depth=depth,
            num_heads=num_heads, class_dropout_prob=class_dropout_prob,
            num_classes=num_classes, learn_sigma=learn_sigma, **kwargs,
        )

    return ctor


# Size registry (reference: models/dit.py:361-382).
DiT_S = _make_dit(384, 12, 6)
DiT_B = _make_dit(768, 12, 12)
DiT_L = _make_dit(1024, 24, 16)
DiT_XL = _make_dit(1152, 28, 16)

DiT_models = {"DiT-S": DiT_S, "DiT-B": DiT_B, "DiT-L": DiT_L, "DiT-XL": DiT_XL}
