"""MM-DiT in PyTorch (counterpart of vaw_tpu/models/mmdit.py; reference:
encoders/mmdit.py:511-695): the SD3-style dual-stream transformer. Each
joint block projects a context stream and the image stream with their own
adaLN modulation and qkv, attends over their concatenation, and splits the
result back; the last block's context stream is pre-only (no output).

Options, all of the JAX model's: a user context through the linear
``context_embedder``, learnable ``register`` tokens before the context, the
``adm_in_channels`` vector path (``y_embedder``), and per block ``qk_norm``
("rms" or "ln"), ``use_rmsnorm``, ``use_swiglu`` and ``scale_mod_only``.
Without a user context a class-conditional model feeds its label embedding
as a ``context_tokens``-token context (the JAX package's extension; its
table is ``label_embed``), and an unconditional one its time embedding.
Positions come from the fixed 16-grid sin-cos table, centre-cropped to the
token grid.

Tokens are [N, T, D] and images NHWC at the interface. The model computes
in its ``compute_dtype`` (default: the dtype of its weights); the norms
normalise in f32 and the head's ``final_layer.linear`` runs in f32
(``keep_f32``), as in the JAX package. Joint attention goes through
``multi_head_attention`` on q, k and v concatenated over the two streams:
the general-T kernels on the card (T = 257 with 24 heads of 32 for
MM-DiT-B/2 on 32x32 latents).

forward returns ``(out, zs)`` as the JAX model does; ``zs`` is always None
here, because the REPA projector tap (``learn_align``) is not ported
(ROADMAP A13). Submodule names are the reference's, the names
vaw_tpu/models/convert.py ``convert_mmdit`` maps from.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from .layers import (
    Linear,
    PatchEmbed,
    TimestepEmbedder,
    check_remat_policy,
    get_2d_sincos_pos_embed,
    remat_with_policy,
    trunc_normal_,
)

__all__ = ["MMDiT", "JointBlock", "RMSNorm", "SwiGLUFeedForward", "GeluMlp"]


def _modulate(x, shift, scale):
    """adaLN modulation with an optional shift (scale_mod_only passes None;
    vaw_tpu/models/mmdit.py:42-48)."""
    y = x * (1 + scale[:, None])
    return y if shift is None else y + shift[:, None]


def _layer_norm(x):
    """Affine-free LayerNorm, eps 1e-6, in f32, cast back to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


def _rms_norm(x, weight=None, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) in f32, times the optional f32 scale, cast
    back to x's dtype (vaw_tpu/models/mmdit.py:51-65)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with a learnable scale (reference: encoders/mmdit.py:289-332),
    the "rms" q/k norm."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _rms_norm(x, self.weight, self.eps)


class _QKLayerNorm(nn.LayerNorm):
    """The "ln" q/k norm: LayerNorm with scale and bias, eps 1e-6, computed
    and returned in f32 (Flax ``LayerNorm(dtype=float32)``)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class SwiGLUFeedForward(nn.Module):
    """w2(silu(w1 x) * w3 x), three bias-free Linears, hidden = 2/3 of the
    nominal width rounded up to a multiple of 256 (reference:
    encoders/mmdit.py:335-371)."""

    def __init__(self, dim: int, nominal_hidden: int, multiple_of: int = 256):
        super().__init__()
        hidden = int(2 * nominal_hidden / 3)
        hidden = multiple_of * ((hidden + multiple_of - 1) // multiple_of)
        self.w1 = Linear(dim, hidden, bias=False)
        self.w3 = Linear(dim, hidden, bias=False)
        self.w2 = Linear(hidden, dim, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class GeluMlp(nn.Module):
    """The default MLP: fc2(gelu_tanh(fc1 x)) (encoders/mmdit.py:31-45)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class StreamAttention(nn.Module):
    """A stream's qkv projection, q/k norms and output projection (the
    reference's ``attn``; no ``proj`` when pre-only)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 qk_norm: Optional[str], pre_only: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        hd = dim // num_heads
        if qk_norm == "rms":
            self.ln_q, self.ln_k = RMSNorm(hd), RMSNorm(hd)
        elif qk_norm == "ln":
            self.ln_q, self.ln_k = _QKLayerNorm(hd), _QKLayerNorm(hd)
        elif qk_norm is None:
            self.ln_q = self.ln_k = None
        else:
            raise ValueError(f"qk_norm {qk_norm!r}: expected None, 'rms' or 'ln'")
        self.proj = None if pre_only else Linear(dim, dim)


class StreamBlock(nn.Module):
    """One stream of a joint block, the reference's DismantledBlock
    (encoders/mmdit.py:373-446; vaw_tpu/models/mmdit.py:104-194): adaLN
    modulation, ``qkv`` before the joint attention and ``post`` after it."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_norm: Optional[str] = None,
                 use_rmsnorm: bool = False, use_swiglu: bool = False,
                 scale_mod_only: bool = False, pre_only: bool = False):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.use_rmsnorm = use_rmsnorm
        self.scale_mod_only = scale_mod_only
        self.pre_only = pre_only
        if scale_mod_only:
            n_mod = 1 if pre_only else 4
        else:
            n_mod = 2 if pre_only else 6
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, n_mod * hidden_size))
        self.attn = StreamAttention(hidden_size, num_heads, qkv_bias, qk_norm,
                                    pre_only)
        self.mlp = None
        if not pre_only:
            nominal = int(hidden_size * mlp_ratio)
            self.mlp = (SwiGLUFeedForward(hidden_size, nominal) if use_swiglu
                        else GeluMlp(hidden_size, nominal))

    def _norm(self, x):
        return _rms_norm(x) if self.use_rmsnorm else _layer_norm(x)

    def _mods(self, c):
        mod = self.adaLN_modulation(c)
        if self.scale_mod_only:
            if self.pre_only:
                return (None, mod), ()
            scale_msa, gate_msa, scale_mlp, gate_mlp = mod.chunk(4, dim=-1)
            return (None, scale_msa), (gate_msa, None, scale_mlp, gate_mlp)
        parts = mod.chunk(2 if self.pre_only else 6, dim=-1)
        if self.pre_only:
            return (parts[0], parts[1]), ()
        return (parts[0], parts[1]), parts[2:]

    def qkv(self, x, c):
        """(q, k, v) each [N, T, H, D], and the modulation ``post`` needs."""
        (shift_msa, scale_msa), rest = self._mods(c)
        y = _modulate(self._norm(x).to(c.dtype), shift_msa, scale_msa)
        n, t, d = y.shape
        q, k, v = self.attn.qkv(y).reshape(
            n, t, 3, self.num_heads, d // self.num_heads).unbind(2)
        if self.attn.ln_q is not None:
            q, k = self.attn.ln_q(q), self.attn.ln_k(k)
        return (q, k, v), rest

    def post(self, x, attn_out, rest):
        gate_msa, shift_mlp, scale_mlp, gate_mlp = rest
        dtype = gate_msa.dtype
        x = x + gate_msa[:, None] * self.attn.proj(attn_out.to(dtype))
        y = _modulate(self._norm(x).to(dtype), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None] * self.mlp(y)


class JointBlock(nn.Module):
    """Joint attention over the two streams (reference:
    encoders/mmdit.py:453-487; vaw_tpu/models/mmdit.py:197-236)."""

    def __init__(self, hidden_size: int, num_heads: int, context_pre_only: bool = False,
                 **kw):
        super().__init__()
        self.context_block = StreamBlock(hidden_size, num_heads,
                                         pre_only=context_pre_only, **kw)
        self.x_block = StreamBlock(hidden_size, num_heads, **kw)

    def forward(self, context, x, c):
        (cq, ck, cv), ctx_rest = self.context_block.qkv(context, c)
        (xq, xk, xv), x_rest = self.x_block.qkv(x, c)
        q, k, v = (torch.cat(pair, dim=1) for pair in ((cq, xq), (ck, xk), (cv, xv)))
        # The "ln" q/k norm returns f32 beside a compute-dtype v; the JAX
        # attention then computes in f32 (its einsums promote), as here.
        dtype = torch.promote_types(q.dtype, v.dtype)
        out = multi_head_attention(q.to(dtype), k.to(dtype), v.to(dtype))
        n, t, h, hd = out.shape
        out = out.reshape(n, t, h * hd)
        ctx_len = context.shape[1]
        x = self.x_block.post(x, out[:, ctx_len:], x_rest)
        if self.context_block.pre_only:
            return None, x
        return self.context_block.post(context, out[:, :ctx_len], ctx_rest), x


class _FinalLayer(nn.Module):
    """adaLN + the f32 linear head (reference: encoders/mmdit.py:489-508)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 2 * hidden_size))
        self.linear = Linear(hidden_size, patch_size ** 2 * out_channels)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        x = _modulate(_layer_norm(x).to(c.dtype), shift, scale)
        return self.linear(x.float())


class _VectorEmbedder(nn.Module):
    """The adm_in_channels path: mlp.2(silu(mlp.0(y))) (reference:
    encoders/mmdit.py:203-215)."""

    def __init__(self, in_channels: int, hidden_size: int):
        super().__init__()
        self.mlp = nn.Sequential(Linear(in_channels, hidden_size), nn.SiLU(),
                                 Linear(hidden_size, hidden_size))

    def forward(self, y):
        return self.mlp(y)


class MMDiT(nn.Module):
    """forward(x [N, H, W, C], t [N], y=None, context=None) -> (out [N, H, W,
    C_out] f32, None).

    y: integer class ids (through ``label_embed``, with label dropout), or,
    with ``adm_in_channels``, an [N, adm_in_channels] vector; context: an
    [N, L, context_dim] token stream, for a model built ``with_context``
    (the Flax model makes its ``context_embedder`` only when it is
    initialised with a context). compute_dtype: the dtype of
    activations and products; None computes in the weights' dtype.
    """

    keep_f32 = ("final_layer",)

    def __init__(self, image_size: int = 32, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 num_classes: int = 1000, use_checkpoint: bool = False,
                 remat_policy: str = "full", adm_in_channels: Optional[int] = None,
                 context_dim: int = 768, with_context: bool = False,
                 context_tokens: int = 1,
                 register_length: int = 0, qkv_bias: bool = True,
                 qk_norm: Optional[str] = None, use_rmsnorm: bool = False,
                 use_swiglu: bool = False, scale_mod_only: bool = False,
                 pos_embed_max_size: int = 16, learn_sigma: bool = False,
                 learn_align: bool = False, class_dropout_prob: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if learn_align:
            raise NotImplementedError(
                "the MM-DiT's REPA projector tap (learn_align) is not ported yet: "
                "ROADMAP A13")
        grid = image_size // patch_size
        if grid > pos_embed_max_size:
            raise ValueError(f"a {grid}x{grid} token grid exceeds the "
                             f"{pos_embed_max_size}-grid position table")
        self.compute_dtype = compute_dtype
        self.use_checkpoint = use_checkpoint
        self.remat_policy = check_remat_policy(remat_policy)
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.num_classes = num_classes
        self.adm_in_channels = adm_in_channels
        self.context_dim = context_dim
        self.context_tokens = context_tokens
        self.class_dropout_prob = class_dropout_prob
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.x_embedder = PatchEmbed(in_channels, patch_size, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = (_VectorEmbedder(adm_in_channels, hidden_size)
                           if adm_in_channels is not None else None)
        self.label_embed = nn.Embedding(
            num_classes + int(class_dropout_prob > 0), hidden_size
        ) if num_classes > 0 and adm_in_channels is None else None
        self.context_embedder = (Linear(context_dim, hidden_size)
                                 if with_context else None)
        self.register = nn.Parameter(
            torch.randn(1, register_length, hidden_size)) if register_length > 0 else None
        # Frozen sin-cos table, centre-cropped from the fixed grid
        # (encoders/mmdit.py:615-636); recomputed, never stored.
        m = pos_embed_max_size
        table = get_2d_sincos_pos_embed(hidden_size, m).reshape(m, m, hidden_size)
        top = left = (m - grid) // 2
        crop = table[top: top + grid, left: left + grid].reshape(grid * grid, -1)
        self.register_buffer("pos_embed", torch.from_numpy(np.ascontiguousarray(crop)),
                             persistent=False)
        block = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_norm=qk_norm,
                     use_rmsnorm=use_rmsnorm, use_swiglu=use_swiglu,
                     scale_mod_only=scale_mod_only)
        self.joint_blocks = nn.ModuleList(
            JointBlock(hidden_size, num_heads, context_pre_only=i == depth - 1, **block)
            for i in range(depth))
        self.final_layer = _FinalLayer(hidden_size, patch_size, self.out_channels)
        self.initialize_weights()

    def initialize_weights(self):
        """The JAX model's initialisers: xavier-uniform qkv projections and
        patch conv, truncated normal(0.02) timestep MLP, normal(0.02) label
        table, normal(1) registers, the adaLN modulations and the head at
        zero, and Flax's default (LeCun normal, zero bias) elsewhere."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                trunc_normal_(module.weight, math.sqrt(1.0 / module.in_features)
                              / 0.87962566103423978)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for blk in self.joint_blocks:
            for stream in (blk.context_block, blk.x_block):
                nn.init.xavier_uniform_(stream.attn.qkv.weight)
                nn.init.zeros_(stream.adaLN_modulation[1].weight)
                nn.init.zeros_(stream.adaLN_modulation[1].bias)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.zeros_(self.x_embedder.proj.bias)
        for i in (0, 2):
            nn.init.trunc_normal_(self.t_embedder.mlp[i].weight, std=0.02,
                                  a=-0.04, b=0.04)
        if self.label_embed is not None:
            nn.init.normal_(self.label_embed.weight, std=0.02)
        for head in (self.final_layer.adaLN_modulation[1], self.final_layer.linear):
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)

    @property
    def has_null_label(self) -> bool:
        """Whether label num_classes, the unconditional label of CFG, exists."""
        return self.label_embed is not None and self.class_dropout_prob > 0

    def forward(self, x, t, y=None, context=None, train: bool = False,
                force_drop_ids=None, generator: Optional[torch.Generator] = None):
        """train turns on label dropout (drawn from `generator`);
        force_drop_ids (1 = drop to the null label) replaces the draw
        (vaw_tpu/models/mmdit.py:305-414)."""
        dtype = self.compute_dtype or self.x_embedder.proj.weight.dtype
        n, hgt, wid, _ = x.shape
        p = self.patch_size
        h_tok, w_tok = hgt // p, wid // p
        x = self.x_embedder(x.to(dtype)) + self.pos_embed.to(dtype)[None]
        c = self.t_embedder(t, dtype)
        user_context = context is not None
        if y is not None and self.y_embedder is not None:
            c = c + self.y_embedder(y.to(dtype))
        elif y is not None and self.label_embed is not None:
            if (train and self.class_dropout_prob > 0) or force_drop_ids is not None:
                if force_drop_ids is None:
                    drop = torch.rand(n, generator=generator,
                                      device=y.device) < self.class_dropout_prob
                else:
                    drop = force_drop_ids == 1
                y = torch.where(drop, self.num_classes, y)
            y_emb = self.label_embed(y).to(dtype)
            c = c + y_emb
            if context is None:
                context = y_emb[:, None].expand(n, self.context_tokens, -1)
        if context is None:
            context = c[:, None].expand(n, self.context_tokens, -1)
        if user_context:
            if self.context_embedder is None:
                raise ValueError("a user context needs a model built with "
                                 "with_context=True")
            if context.shape[-1] != self.context_dim:
                raise ValueError(f"context last dim {context.shape[-1]} != "
                                 f"context_dim {self.context_dim}")
            context = self.context_embedder(context.to(dtype))
        if self.register is not None:
            reg = self.register.to(context.dtype).expand(n, -1, -1)
            context = torch.cat([reg, context], dim=1)
        for blk in self.joint_blocks:
            run = (remat_with_policy(blk, self.remat_policy)
                   if self.use_checkpoint else blk)
            context, x = run(context, x, c)
        x = self.final_layer(x, c)
        c_out = self.out_channels
        x = x.reshape(n, h_tok, w_tok, p, p, c_out).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h_tok * p, w_tok * p, c_out).float(), None
