"""P and dS as one bf16 term in the general wgmma attention pair, and the
forward's key tile (vaw_torch/ops/flash_attention.py:
``flash_fwd_key_tile``; csrc/flash_fwd.cu:flash_fwd_wgmma,
csrc/flash_bwd.cu:flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma, whose terms
are the constant ``kBwdTerms``).

The card's bf16 kernels round P (forward), P^T and dS (backward) to bf16
once before their tensor-core products, as FlashAttention does; scores,
softmax, the running max and sum, and every accumulator stay f32. No kernel
runs here, so a plain emulation of that rounding (inside this file: the
forward walks key tiles of the plan's size with an online softmax) is held
against the JAX package's ``_flash`` forward and backward, its Pallas
kernels in interpret mode (as tests/test_ops.py runs them), on the same
bf16-rounded inputs, within the card tests' bf16 tolerances: o atol 1e-2
(one bf16 rounding of |o| < 2), lse atol 1e-4, each gradient within 2e-2
of its max|grad|. The rules and their place in the launch plans' tails run
on CPU tensors (the plan builders read dtypes, shapes and strides only).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import _torch_bwd_terms
from _torch_bwd_terms import bwd_terms, padded
from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import flash_fwd_key_tile

SHAPES = [(2, t, 2, d) for t in (64, 130, 256) for d in (32, 64, 72)]


def _inputs(b, t, h, d, seed):
    """q, k at 0.5 and v, g at 1, rounded to bf16 and held in f32."""
    rng = np.random.default_rng(seed)
    q, k = ((rng.standard_normal((b, t, h, d)) * 0.5).astype(np.float32) for _ in range(2))
    v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(2))
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float() for a in (q, k, v, g))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even, as
    __floats2bfloat162_rn rounds), held in f32."""
    return x.to(torch.bfloat16).float()


def single_term_forward(q, k, v, scale, key_tile):
    """The bf16 wgmma forward's arithmetic on [B, T, H, D] f32 tensors: per
    tile of `key_tile` keys, S in f32, the online softmax's running max and
    f32 sum, P rounded once to bf16 for P.V, O rescaled in f32; o rounded
    to bf16 at the end. Returns (o, lse [B*H, T])."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, t, d]
    m = torch.full((b, h, tq, 1), -math.inf)
    l = torch.zeros((b, h, tq, 1))
    o = torch.zeros((b, h, tq, d))
    for k0 in range(0, tk, key_tile):
        s = (qh @ kh[:, :, k0:k0 + key_tile].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _bf16(p) @ vh[:, :, k0:k0 + key_tile]
        m = m_new
    lse = (m + torch.log(l)).reshape(b * h, tq)
    return _bf16(o / l).transpose(1, 2), lse


def single_term_backward(q, k, v, out, lse, dout, scale):
    """The bf16 wgmma backward pair's arithmetic: P from lse and dP in f32,
    delta = rowsum(dout * out) from the bf16 out, dS = P (dP - delta) in
    f32; P^T and dS (dS^T) rounded once to bf16 before dV += P^T dout,
    dQ += dS k and dK += dS^T q; dQ and dK scaled at the end; each gradient
    rounded to bf16. Returns (dq, dk, dv) as [B, T, H, D]."""
    b, tq, h, d = q.shape
    qh, kh, vh, oh, dh = (x.transpose(1, 2) for x in (q, k, v, out, dout))
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse.reshape(b, h, tq, 1))
    delta = (dh * oh).sum(-1, keepdim=True)
    ds = _bf16(p * (dh @ vh.transpose(-1, -2) - delta))
    dv = _bf16(p).transpose(-1, -2) @ dh
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    return tuple(_bf16(g).transpose(1, 2) for g in (dq, dk, dv))


def _jax_flash(q, k, v, g):
    """The JAX package's flash_attention (``_flash``: Pallas in interpret
    mode on the CPU) and its gradient against g."""
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    args = tuple(jnp.asarray(x.numpy()) for x in (q, k, v))
    out = jax_flash.flash_attention(*args)
    grads = jax.grad(lambda *a: jnp.sum(jax_flash.flash_attention(*a) * g.numpy()),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_single_term_forward_matches_jax_flash(b, t, h, d):
    """The emulated one-term forward, on the key tile the plan takes for
    this T, within the card's bf16 tolerance of the JAX package's f32
    forward; its lse matches the f32 plain version's."""
    q, k, v, g = _inputs(b, t, h, d, seed=t + d)
    scale = d ** -0.5
    tile = flash_fwd_key_tile(t, t, port_flash._wgmma_dp(d))
    o, lse = single_term_forward(q, k, v, scale, tile)
    want, _ = _jax_flash(q, k, v, g)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-2, rtol=0)
    _, want_lse = port_flash.flash_attention_reference(q, k, v, scale)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_single_term_backward_matches_jax_flash(b, t, h, d):
    """The emulated one-term backward, from the emulated forward's bf16 o
    and lse, within 2e-2 of max|grad| of the JAX package's f32 gradients
    (the card's pair takes one term at every head dim, D = 72 too)."""
    q, k, v, g = _inputs(b, t, h, d, seed=2 * t + d)
    scale = d ** -0.5
    tile = flash_fwd_key_tile(t, t, port_flash._wgmma_dp(d))
    o, lse = single_term_forward(q, k, v, scale, tile)
    got = single_term_backward(q, k, v, o, lse, _bf16(g), scale)
    _, want = _jax_flash(q, k, v, g)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(x.numpy() - w).max()
        assert err <= 2e-2 * np.abs(w).max(), (name, err, np.abs(w).max())


def test_one_term_rounds_where_two_terms_keep_16_bits():
    """What the two designs keep of P in (0, 1]: one term is P rounded to
    bf16 (8 significant bits: relative error at most 2^-8), hi + lo about
    16 (hi cut to bf16, lo = bf16(P - hi): at most 2^-15), as
    hopper_common.cuh's round_p and split_p form them."""
    p = torch.rand(4096) * 0.999 + 1e-3
    one = _bf16(p)
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    two = hi + _bf16(p - hi)
    assert ((one - p).abs() / p).max().item() <= 2.0 ** -8
    assert ((two - p).abs() / p).max().item() <= 2.0 ** -15


# (Tq, Tk, padded D, keys a tile) at the models' bf16 forwards: DiT-B/2's
# 256 and LDM's and ADM-64's 1024 (D 32, 64; two consumer warpgroups) take
# 128; U-ViT-L/2's and ViT-B/2's 258, MM-DiT-B/2's 257, the UNets' 64, a
# call on three consumer warpgroups (Tq 300, or 256 at D = 32) and every
# head dim above 64 take 64.
KEY_TILES = [(256, 256, 64, 128), (1024, 1024, 32, 128), (1024, 1024, 64, 128),
             (256, 1024, 64, 128), (258, 258, 64, 64), (257, 257, 32, 64), (64, 64, 32, 64),
             (64, 64, 64, 64), (130, 130, 64, 64), (300, 1024, 64, 64), (256, 256, 32, 64),
             (256, 256, 80, 64), (258, 258, 80, 64), (1024, 1024, 128, 64),
             (256, 256, 128, 64)]


@pytest.mark.parametrize("tq,tk,dp,want", KEY_TILES)
def test_key_tile_rule(tq, tk, dp, want):
    assert flash_fwd_key_tile(tq, tk, dp) == want


@pytest.mark.parametrize("dp,want", [(32, 1), (64, 1), (80, 1), (96, 1), (128, 1)])
def test_backward_terms_rule(dp, want):
    """One term at each width the C entry dispatches to, the XL models'
    80-wide tiles too: on the card each gradient's rms error against the
    f32 plain version is SDPA's at every width (flash_bwd.cu:kBwdTerms)."""
    assert dp in _torch_bwd_terms.widths()
    assert bwd_terms() == want


def test_three_consumers_keep_64_key_tiles(monkeypatch):
    """Three consumer warpgroups run 64-key tiles: beside S's 64 floats a
    thread's registers spill (the kernel takes 128 keys with two only)."""
    monkeypatch.setattr(port_flash, "flash_fwd_consumers", lambda tq, dp: 3)
    assert flash_fwd_key_tile(1024, 1024, 64) == flash_fwd_key_tile(256, 256, 32) == 64


def _packed(b, t, h, d, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(0)
    return torch.randn((b, t, 3, h, d), generator=gen).to(dtype)


@pytest.mark.parametrize("b,tq,tk,h,d", [(2, 256, 256, 12, 64), (2, 1024, 1024, 6, 64),
                                         (2, 1024, 1024, 8, 32), (2, 258, 258, 16, 64),
                                         (2, 77, 300, 3, 32), (2, 256, 256, 4, 72),
                                         (2, 258, 258, 4, 128)])
def test_forward_plan_tail(b, tq, tk, h, d):
    """A bf16 general forward's plan ends in the consumer warpgroups and
    the key tile (of Tk, and of Tq through the consumers), in the C entry's
    order."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((b, tq, h, d), generator=gen).bfloat16()
    k, v = (torch.randn((b, tk, h, d), generator=gen).bfloat16() for _ in range(2))
    plan = port_flash._general_fwd_plan(q, k, v, d ** -0.5)
    dp = port_flash._wgmma_dp(d)
    assert plan.design == "wgmma"
    assert plan.tail == (port_flash.flash_fwd_consumers(tq, dp), flash_fwd_key_tile(tq, tk, dp))


@pytest.mark.parametrize("t,d", [(256, 64), (1024, 32), (257, 64), (256, 72)])
def test_fused_forward_plan_tail(t, d):
    """The fused entry's bf16 forward on the packed row's views carries the
    same tail, the key tile of its T."""
    qkv2d = _packed(2, t, 4, d).view(2, t, 3 * 4 * d)
    plan = port_flash._fused_fwd_plan(qkv2d, 4, d ** -0.5)
    dp = port_flash._wgmma_dp(d)
    assert plan.tail == (port_flash.flash_fwd_consumers(t, dp), flash_fwd_key_tile(t, t, dp))


@pytest.mark.parametrize("d,dp", [(32, 32), (64, 64), (72, 80), (96, 96), (128, 128)])
def test_backward_plan_tails(d, dp):
    """The bf16 backward pair's plan carries no trailing ints: the terms
    of P and dS are the kernels' constant (kBwdTerms), not a choice of
    the call; f32 on tf32x3 ends in nothing too."""
    b, t, h = 2, 64, 2
    qkv = _packed(b, t, h, d)
    q, k, v = qkv.unbind(2)
    out = torch.zeros((b, t, h, d), dtype=torch.bfloat16)
    lse = torch.zeros((b * h, t))
    grads = torch.empty_like(qkv).unbind(2)
    plan = port_flash._general_bwd_plan(q, k, v, out, lse, out, d ** -0.5, grads)
    assert padded(d) == dp
    assert (plan.design, plan.tail, plan.dims) == ("wgmma", (), (b, t, t, h, d))
    if d <= 64:
        f32 = [x.float() for x in (q, k, v, out, out)]
        plan = port_flash._general_bwd_plan(*f32[:4], lse, f32[4], d ** -0.5,
                                            tuple(x.float() for x in grads))
        assert (plan.design, plan.tail) == ("tf32x3", ())
