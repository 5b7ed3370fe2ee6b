"""The f32 designs on the tensor cores, "tf32x3", of the DiT's fused
backward (B2, the general pair of vaw_torch/ops/csrc/flash_bwd.cu on the
packed row's views) and of the UNet's d-major p5 forward (B3,
vaw_torch/ops/csrc/flash_p5_fwd.cu: flash_p5_fwd_tf32x3): which calls take
them, and the p5 forward's numerics, emulated on the CPU, against the plain
version and the JAX package's _flash_p5 forward (Pallas in interpret mode).

The p5 kernel takes every f32 product as three TF32 passes, as the general
forward does (tests/test_torch_flash_tf32x3.py): x = hi + lo, hi x rounded
to TF32, lo = x - hi rounded in turn, a product lo.hi + hi.lo + hi.hi with
f32 sums. ``tf32x3_p5_forward`` repeats that split on f5's d-major
sections, the kernel's 64-key tiles and its online softmax in the log2
domain, in plain torch. K^T's rows hold each 8-key group in the order 0, 4,
1, 5, 2, 6, 3, 7 on the card, which moves no value between keys.

Tolerances are those the p5 forward is held to on the card (chip_smoke.py:
ATOL[float32] 2e-5 on o, LSE_ATOL 1e-4 on lse): the emulation meets them
against both references at T = 256 with D = 32 and 64; one TF32 pass misses
them by ten times and more.

A call takes tf32x3 at or above the crossover (``TF32X3_MIN_TILES`` score
tiles), with a positive scale and D <= 64; other f32 calls keep their FMA
kernels. JAX is imported inside the tests that compare with it; the
card's tests (marked ``cuda``) hold the kernels themselves to the plain
versions.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from test_torch_flash_tf32x3 import _mm1, _mm3

from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    TF32X3_MIN_TILES,
    flash_attention_fused,
    flash_attention_fused_bwd,
    flash_attention_fused_bwd_reference,
    flash_attention_fused_reference,
    flash_attention_p5,
    flash_attention_p5_fwd,
    flash_attention_p5_reference,
    flash_fused_bwd_design,
    flash_p5_fwd_design,
    score_tiles,
)

ATOL, LSE_ATOL = 2e-5, 1e-4
BWD_RTOL = 1e-4
# T = 256 (the JAX gate's p5 T) at LDM's D = 32 and the classifier's D = 64,
# B * H of 2 to 4.
P5_SHAPES = [(1, 256, 2, 32), (2, 256, 2, 32), (1, 256, 4, 64), (2, 256, 2, 64)]


def tf32x3_p5_forward(f5, scale=None, mm=_mm3):
    """The p5 kernel's arithmetic on f5 [B, 3, H, D, T] f32: raw scores
    S = q^T k by `mm` over d, 64-key tiles, the running max of the scaled
    scores in the log2 domain, P = exp2(S * scale * log2(e) - m), O = P v^T
    by `mm` over the keys. Returns (o [B*H, D, T] d-major, lse [B*H, T])."""
    b, _, h, d, t = f5.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, k, v = (f5[:, i].reshape(b * h, d, t) for i in range(3))
    qt = q.transpose(1, 2)  # [bh, t, d]
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    m = torch.full((b * h, t, 1), -math.inf)
    l = torch.zeros((b * h, t, 1))
    o = torch.zeros((b * h, t, d))
    for k0 in range(0, t, 64):
        s = mm(qt, k[:, :, k0:k0 + 64])
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[:, :, k0:k0 + 64].transpose(1, 2))
        m = m_new
    lse = (m + torch.log2(l)) * math.log(2.0)
    return (o / l).transpose(1, 2).contiguous(), lse.reshape(b * h, t)


def _f5(b, t, h, d, seed=0):
    """f5 [B, 3, H, D, T] of unit normals, q and k at 0.5 (chip_smoke.py:
    _p5_inputs)."""
    f5 = np.random.default_rng(seed).standard_normal((b, 3, h, d, t)).astype(np.float32)
    f5[:, :2] *= 0.5
    return f5


@pytest.mark.parametrize("b,t,h,d", P5_SHAPES)
def test_p5_split_holds_the_f32_tolerance(b, t, h, d):
    """The emulated kernel within ATOL (o) and LSE_ATOL (lse) of the plain
    version and of the JAX package's Pallas p5 forward."""
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    f5 = _f5(b, t, h, d, seed=t + d + b)
    o, lse = tf32x3_p5_forward(torch.from_numpy(f5))
    want_o, want_lse = flash_attention_p5_reference(torch.from_numpy(f5))
    assert o.shape == (b * h, d, t) and lse.shape == (b * h, t)
    assert (o - want_o).abs().max().item() <= ATOL
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL
    jax_o, (_, _, jax_lse) = jax_flash._flash_p5_fwd(jnp.asarray(f5), 1.0 / math.sqrt(d))
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse), atol=LSE_ATOL, rtol=0)


def test_one_tf32_pass_misses_the_p5_tolerance():
    """One TF32 pass a product keeps about three digits: at the
    classifier's head dim its o lies ten times further from the plain
    version than the three-pass split's, and outside ATOL."""
    f5 = torch.from_numpy(_f5(2, 256, 2, 64, seed=1))
    want, _ = flash_attention_p5_reference(f5)
    three = (tf32x3_p5_forward(f5)[0] - want).abs().max().item()
    one = (tf32x3_p5_forward(f5, mm=_mm1)[0] - want).abs().max().item()
    assert three <= ATOL
    assert one > 10 * three and one > ATOL


@pytest.mark.parametrize("b,h,d,scale,design", [
    (4, 9, 64, 0.125, "tf32x3"),     # the classifier's 16 px blocks: 576 tiles
    (2, 9, 64, 0.125, "fma"),        # 288
    (3, 12, 64, 0.125, "tf32x3"),    # 576
    (1, 35, 32, 32 ** -0.5, "fma"),  # 560
    (16, 16, 32, 32 ** -0.5, "tf32x3"),   # LDM's gradient check
    (128, 16, 32, 32 ** -0.5, "tf32x3"),  # LDM's sampling batch
    (8, 16, 40, 0.3, "tf32x3"),      # D = 40 pads to 64
    (8, 16, 8, 0.3, "tf32x3"),
    (8, 16, 72, 0.3, "fma"),         # D > 64: its shared memory
    (16, 4, 128, 128 ** -0.5, "fma"),
    (16, 16, 32, -0.3, "fma"),       # the softmax takes the max on raw scores
    (16, 16, 32, 0.0, "fma")])
def test_p5_forward_design_in_f32(b, h, d, scale, design):
    """f32 with scale > 0 and D <= 64 takes the 3xTF32 kernel at or above
    TF32X3_MIN_TILES score tiles, the FMA kernel otherwise; bf16 keeps
    its rule at every size."""
    shape = (b, 3, h, d, 256)
    assert (score_tiles(b, 256, 256, h) >= TF32X3_MIN_TILES) == (
        design == "tf32x3" or d > 64 or scale <= 0)
    assert flash_p5_fwd_design(torch.float32, scale, shape) == design
    assert flash_p5_fwd_design(torch.bfloat16, scale, shape) == (
        "wgmma" if scale > 0 else "mma_sync")


def _packed_views(b, t, h, d, dtype=torch.float32):
    """q, k, v and dq, dk, dv of a packed [B, T, 3*H*D] row on the meta
    device: the views the fused backward hands its design."""
    qkv = torch.empty((b, t, 3, h, d), dtype=dtype, device="meta")
    return qkv.unbind(2) * 2


@pytest.mark.parametrize("b,t,h,d,design", [
    (256, 256, 12, 64, "tf32x3"),   # DiT-B/2 at --amp False's batch
    (32, 256, 12, 64, "tf32x3"),    # DiT-B/2's f32 gradient check
    (1, 256, 12, 64, "fma"),        # 192 tiles
    (3, 256, 12, 64, "tf32x3"),     # 576
    (256, 256, 16, 72, "fma"),      # DiT-XL/2: D = 72
    (16, 256, 4, 128, "fma"),
    (16, 257, 12, 32, "tf32x3"),
    (4, 256, 6, 8, "fma")])         # 384 tiles
def test_fused_backward_design_in_f32(b, t, h, d, design):
    """B2's f32 calls take the general pair's 3xTF32 design on the packed
    row's views by flash_bwd_design's rule (D <= 64, scale > 0, at least
    TF32X3_MIN_TILES score tiles), the fused FMA kernels otherwise."""
    assert (score_tiles(b, t, t, h) >= TF32X3_MIN_TILES) == (design == "tf32x3" or d > 64)
    views = _packed_views(b, t, h, d)
    assert flash_fused_bwd_design(torch.float32, d, d ** -0.5, views) == design
    assert flash_fused_bwd_design(torch.float32, d, -0.2, views) == "fma"
    assert flash_fused_bwd_design(torch.bfloat16, d, d ** -0.5,
                                  _packed_views(b, t, h, d, torch.bfloat16)) == (
        "wgmma" if d <= 128 else "mma_sync")


def test_cpu_calls_count_no_tf32x3_launch():
    """On the CPU the p5 forward and the fused backward run their plain
    versions, equal to them, and count no launch."""
    before = (flash_attention_p5.launches, dict(flash_attention_p5.launches_by_design),
              flash_attention_fused_bwd.launches,
              dict(flash_attention_fused_bwd.launches_by_design))
    f5 = torch.from_numpy(_f5(4, 256, 9, 64, seed=2))
    assert flash_p5_fwd_design(torch.float32, 0.125, f5.shape) == "tf32x3"
    for x, w in zip(flash_attention_p5_fwd(f5), flash_attention_p5_reference(f5)):
        assert torch.equal(x, w)
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((3, 256, 3 * 12 * 64)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((3, 256, 12 * 64)).astype(np.float32))
    out, lse = flash_attention_fused(qkv, 12)
    assert torch.equal(flash_attention_fused_bwd(qkv, out, lse, dout, 12),
                       flash_attention_fused_bwd_reference(qkv, out, lse, dout, 12))
    assert (flash_attention_p5.launches, flash_attention_p5.launches_by_design,
            flash_attention_fused_bwd.launches,
            flash_attention_fused_bwd.launches_by_design) == before


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


# Both padded head dims (32, 64; D = 8, 16, 40 zero-filled by TMA), a ragged
# T (a masked key tile, an idle warpgroup), T = 1024 (16 key tiles), T = 64
# (one tile, one idle warpgroup) and the classifier's and LDM's shapes.
CUDA_P5_SHAPES = [(4, 256, 9, 64), (16, 256, 16, 32), (2, 256, 8, 16), (3, 256, 5, 8),
                  (2, 256, 3, 40), (2, 136, 2, 32), (2, 1024, 2, 24), (1, 200, 3, 64),
                  (2, 64, 3, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", CUDA_P5_SHAPES)
def test_cuda_p5_tf32x3_matches_reference(b, t, h, d, monkeypatch):
    """Every shape through the 3xTF32 kernel (the crossover set to 0),
    counted, bit-equal when repeated, within ATOL and LSE_ATOL of the plain
    version."""
    _cuda()
    monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", 0)
    f5 = torch.from_numpy(_f5(b, t, h, d, seed=5)).cuda()
    before = dict(flash_attention_p5.launches_by_design)
    o, lse = flash_attention_p5_fwd(f5)
    again = flash_attention_p5_fwd(f5)
    torch.cuda.synchronize()
    before["tf32x3"] += 2
    assert flash_attention_p5.launches_by_design == before
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    want, want_lse = flash_attention_p5_reference(f5)
    assert o.shape == (b * h, d, t)
    assert (o - want).abs().max().item() <= ATOL
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 12, 64), (3, 257, 12, 64), (16, 256, 4, 8)])
def test_cuda_fused_backward_takes_tf32x3_in_f32(b, t, h, d):
    """B2's f32 calls at or above the crossover run the general pair's
    3xTF32 design, counted under the fused backward, bit-equal when
    repeated, within BWD_RTOL of max|dqkv|."""
    _cuda()
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy((rng.standard_normal((b, t, 3 * h * d)) * 0.5)
                           .astype(np.float32)).cuda()
    dout = torch.from_numpy(rng.standard_normal((b, t, h * d)).astype(np.float32)).cuda()
    out, lse = flash_attention_fused_reference(qkv, h)
    assert flash_fused_bwd_design(torch.float32, d, d ** -0.5,
                                  _packed_views(b, t, h, d)) == "tf32x3"
    before = dict(flash_attention_fused_bwd.launches_by_design)
    got = flash_attention_fused_bwd(qkv, out, lse, dout, h)
    again = flash_attention_fused_bwd(qkv, out, lse, dout, h)
    torch.cuda.synchronize()
    before["tf32x3"] += 2
    assert flash_attention_fused_bwd.launches_by_design == before
    assert torch.equal(got, again)
    want = flash_attention_fused_bwd_reference(qkv, out, lse, dout, h)
    assert (got - want).abs().max().item() <= BWD_RTOL * want.abs().max().item()
