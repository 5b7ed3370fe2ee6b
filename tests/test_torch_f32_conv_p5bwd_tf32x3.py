"""The f32 designs on the tensor cores, "tf32x3", of the conv forward and
its dgrad (B7, vaw_torch/ops/csrc/conv3x3_fwd.cu: conv3x3_fwd_tf32x3) and of
the UNet's d-major p5 backward (B4, vaw_torch/ops/csrc/flash_p5_bwd.cu:
flash_p5_bwd_dq_tf32x3, flash_p5_bwd_dkdv_tf32x3): which calls take them,
and their numerics, emulated on the CPU, against the plain versions and the
JAX package's Pallas kernels (conv3x3_pallas and _flash_p5's backward, in
interpret mode).

Each kernel takes every f32 product as three TF32 passes: x = hi + lo, hi x
rounded to TF32, lo = x - hi rounded in turn, a product lo.hi + hi.lo +
hi.hi. ``tf32x3_conv`` repeats the conv kernel's K steps (32 channels of one
tap, tap-major), each step's three passes summed on their own and then
added to running f32 sums; ``tf32x3_p5_bwd`` runs the p5 pair's five
products through the general pair's emulation
(tests/test_torch_f32_bwd_tf32x3.py) on f5's sections, d-major in and out.
The p5 kernels' reordering of each 8-token group in their transposed tiles
moves no value between tokens.

Tolerances are those the kernels are held to on the card (chip_smoke.py:
CONV_RTOL[float32] 1e-5 on y and dx, BWD_RTOL[float32] 1e-4 on dqkv, each
relative to the largest value): the emulation meets them against both
references, and one TF32 pass misses them by ten times and more.

JAX is imported inside the tests that compare with it; the card's tests
(marked ``cuda``) hold the kernels themselves to the plain versions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch
from test_torch_f32_bwd_tf32x3 import tf32x3_attention_bwd
from test_torch_flash_tf32x3 import _mm1, _mm3

from vaw_torch.ops import conv2d as port_conv
from vaw_torch.ops.flash_attention import (
    P5_TF32X3_MIN_TILES,
    flash_attention_p5,
    flash_attention_p5_bwd,
    flash_attention_p5_bwd_reference,
    flash_attention_p5_fwd,
    flash_attention_p5_reference,
    flash_p5_bwd_design,
    flash_p5_fwd_design,
    score_tiles,
)

CONV_RTOL = 1e-5
BWD_RTOL = 1e-4


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def tf32x3_conv(x, w, mm=_mm3):
    """The tf32x3 conv's arithmetic on x [N, H, W, Cin] and w [3, 3, Cin,
    Cout] f32: for each tap and each 32 channels of it, the shifted x
    [N*H*W, 32] @ w [32, Cout] by `mm`, added in that order to f32 sums."""
    n, h, wd, cin = x.shape
    y = torch.zeros((n * h * wd, w.shape[-1]))
    for dy, dx, tap in port_conv._taps(x):
        for c0 in range(0, cin, 32):
            y = y + mm(tap[:, c0:c0 + 32], w[dy, dx, c0:c0 + 32])
    return y.reshape(n, h, wd, -1)


def tf32x3_p5_bwd(f5, out, lse, dout, scale=None, mm=_mm3):
    """The tf32x3 p5 pair's arithmetic on f5 [B, 3, H, D, T] f32, out and
    dout [B*H, D, T] and lse [B*H, T]: the five products of the general
    pair's emulation on [B, T, H, D] views of f5's sections. Returns dqkv
    [B, 3, H, D, T]."""
    b, _, h, d, t = f5.shape
    q, k, v = (f5[:, i].permute(0, 3, 1, 2) for i in range(3))
    o, g = (x.reshape(b, h, d, t).permute(0, 3, 1, 2) for x in (out, dout))
    grads = tf32x3_attention_bwd(q, k, v, o, lse, g, scale, mm)
    return torch.stack([x.permute(0, 2, 3, 1) for x in grads], dim=1)


def _conv_inputs(n, h, w, cin, cout, seed=0):
    """x, w (scaled by 1 / sqrt(9 Cin)) and a cotangent g, as chip_smoke.py
    draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, wt, g))


def _f5(b, t, h, d, seed=0):
    """f5 [B, 3, H, D, T] (q and k at 0.5) and dout [B*H, D, T] of unit
    normals (chip_smoke.py: _p5_inputs)."""
    rng = np.random.default_rng(seed)
    f5 = rng.standard_normal((b, 3, h, d, t)).astype(np.float32)
    f5[:, :2] *= 0.5
    g = rng.standard_normal((b * h, d, t)).astype(np.float32)
    return torch.from_numpy(f5), torch.from_numpy(g)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                             interpret=True))


# A forward and its dgrad (Cin and Cout swapped) with Cin and Cout multiples
# of 64, the shapes the tf32x3 conv takes: K = 576 and 1152.
CONV_SHAPE = (2, 8, 8, 64, 128)


def test_conv_split_holds_the_f32_tolerance(interpret):
    """The emulated conv within CONV_RTOL of the plain version and of the
    JAX package's conv3x3_pallas (interpret mode), in y and in the dgrad."""
    import jax.numpy as jnp

    from vaw_tpu.ops import conv2d as jax_conv

    x, wt, g = _conv_inputs(*CONV_SHAPE)
    w_rot = wt.flip(0, 1).transpose(2, 3).contiguous()
    for name, inp, filt in (("y", x, wt), ("dx", g, w_rot)):
        got = tf32x3_conv(inp, filt)
        assert _rel(got, port_conv.conv3x3_reference(inp, filt)) <= CONV_RTOL, name
        want = torch.from_numpy(np.array(jax_conv.conv3x3_pallas(
            jnp.asarray(inp.numpy()), jnp.asarray(filt.numpy()))))
        assert want.shape == got.shape
        assert _rel(got, want) <= CONV_RTOL, name


def test_one_tf32_pass_misses_the_conv_tolerance():
    x, wt, _ = _conv_inputs(*CONV_SHAPE, seed=1)
    plain = port_conv.conv3x3_reference(x, wt)
    three = _rel(tf32x3_conv(x, wt), plain)
    one = _rel(tf32x3_conv(x, wt, mm=_mm1), plain)
    assert three <= CONV_RTOL
    assert one > 10 * three and one > CONV_RTOL


# T = 256 (the JAX gate's p5 T) at LDM's D = 32 and the classifier's D = 64.
P5_SHAPES = [(1, 256, 2, 32), (1, 256, 2, 64)]


@pytest.mark.parametrize("b,t,h,d", P5_SHAPES)
def test_p5_backward_split_holds_the_f32_tolerance(b, t, h, d):
    """The emulated pair within BWD_RTOL of the plain version and of the JAX
    package's _flash_p5 backward (_bwd_kernel_p5, interpret mode)."""
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    f5, g = _f5(b, t, h, d, seed=d)
    scale = 1.0 / math.sqrt(d)
    _, res = jax_flash._flash_p5_fwd(jnp.asarray(f5.numpy()), scale)
    (want,) = jax_flash._flash_p5_bwd(scale, res, jnp.asarray(g.numpy()))
    _, out, lse = (torch.from_numpy(np.array(r)) for r in res)
    got = tf32x3_p5_bwd(f5, out, lse, g)
    assert got.shape == f5.shape
    assert _rel(got, torch.from_numpy(np.array(want))) <= BWD_RTOL
    assert _rel(got, flash_attention_p5_bwd_reference(f5, out, lse, g)) <= BWD_RTOL


def test_one_tf32_pass_misses_the_p5_backward_tolerance():
    f5, g = _f5(2, 256, 2, 64, seed=1)
    out, lse = flash_attention_p5_reference(f5)
    plain = flash_attention_p5_bwd_reference(f5, out, lse, g)
    three = _rel(tf32x3_p5_bwd(f5, out, lse, g), plain)
    one = _rel(tf32x3_p5_bwd(f5, out, lse, g, mm=_mm1), plain)
    assert three <= BWD_RTOL
    assert one > 10 * three and one > BWD_RTOL


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("shape,cout,design", [
    ((64, 64, 64, 192), 192, "tf32x3"),   # ADM-64's 64 px convs at --amp False's batch
    ((4, 8, 8, 768), 768, "tf32x3"),      # the classifier's 8 px blocks
    ((4, 16, 16, 384), 576, "tf32x3"),
    ((3, 12, 20, 64), 128, "tf32x3"),
    ((64, 64, 64, 3), 192, "fma"),        # the stem
    ((64, 64, 64, 192), 3, "fma"),        # the head
    ((2, 8, 8, 96), 64, "fma"),           # Cin % 64 != 0
    ((2, 8, 8, 64), 96, "fma")])          # Cout % 64 != 0
def test_conv_design_in_f32(shape, cout, design):
    """f32 convs (and dgrads) with Cin and Cout multiples of 64 take the
    3xTF32 kernel, the others the FMA kernel; bf16 keeps its rule."""
    assert port_conv.conv3x3_design(shape, cout, torch.float32) == design
    assert port_conv.conv3x3_design(shape, cout, torch.bfloat16) == (
        "wgmma" if design == "tf32x3" else "mma_sync")


@pytest.mark.parametrize("h,w,cout,tiling", [
    (64, 64, 192, (1, 2, 64, 96)), (32, 32, 384, (1, 4, 32, 96)),
    (16, 16, 576, (1, 8, 16, 96)), (8, 8, 768, (2, 8, 8, 96)),
    (12, 20, 128, (1, 4, 32, 64)), (3, 5, 64, (4, 4, 8, 64))])
def test_conv_tf32x3_tiling(h, w, cout, tiling):
    """The wgmma kernel's 128-pixel box, BN 96 where it divides Cout, else
    64."""
    got = port_conv.conv3x3_tf32x3_tiling(h, w, cout)
    assert got == tiling
    bni, bh, bw, bn = got
    assert bni * bh * bw == 128 and cout % bn == 0


@pytest.mark.parametrize("b,h,d,scale,design", [
    (4, 9, 64, 0.125, "tf32x3"),       # the classifier's 16 px blocks: 576 tiles
    (2, 9, 64, 0.125, "tf32x3"),       # 288
    (16, 16, 32, 32 ** -0.5, "tf32x3"),   # LDM's gradient check
    (128, 16, 32, 32 ** -0.5, "tf32x3"),  # LDM's f32 row
    (2, 16, 32, 32 ** -0.5, "tf32x3"),    # 512
    (1, 1, 64, 0.125, "tf32x3"),       # 16
    (8, 16, 40, 0.3, "tf32x3"),        # D = 40 pads to 64
    (8, 16, 72, 0.3, "fma"),           # D > 64
    (16, 4, 128, 128 ** -0.5, "fma"),
    (16, 16, 32, -0.3, "fma"),
    (16, 16, 32, 0.0, "fma")])
def test_p5_backward_design_in_f32(b, h, d, scale, design):
    """f32 with D <= 64 and scale > 0 takes the 3xTF32 pair at every size
    (no crossover: it beats the FMA kernels down to 288 score tiles), the
    FMA kernels otherwise; the forward's crossover does not apply. bf16
    keeps its rule."""
    assert flash_p5_bwd_design(torch.float32, d, scale) == design
    if score_tiles(b, 256, 256, h) < P5_TF32X3_MIN_TILES and d <= 64 and scale > 0:
        assert flash_p5_fwd_design(torch.float32, scale, (b, 3, h, d, 256)) == "fma"
    assert flash_p5_bwd_design(torch.bfloat16, d, scale) == (
        "wgmma" if d <= 128 and scale > 0 else "mma_sync")


def test_cpu_calls_count_no_tf32x3_launch():
    """On the CPU the conv and the p5 backward run their plain versions,
    equal to them, and count no launch."""
    before = (dict(port_conv.conv3x3_pallas.launches_by_design),
              dict(flash_attention_p5_bwd.launches_by_design))
    x, wt, _ = _conv_inputs(1, 8, 8, 64, 64)
    assert port_conv.conv3x3_design(x.shape, 64, torch.float32) == "tf32x3"
    assert torch.equal(port_conv.conv3x3_pallas(x, wt), port_conv.conv3x3_reference(x, wt))
    f5, g = _f5(4, 256, 9, 64, seed=2)
    assert flash_p5_bwd_design(torch.float32, 64, 0.125) == "tf32x3"
    out, lse = flash_attention_p5_fwd(f5)
    assert torch.equal(flash_attention_p5_bwd(f5, out, lse, g),
                       flash_attention_p5_bwd_reference(f5, out, lse, g))
    assert (port_conv.conv3x3_pallas.launches_by_design,
            flash_attention_p5_bwd.launches_by_design) == before


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


# ADM-64's f32 widths (192 to 768 channels; BN 96 and 64), a box that
# straddles the image (3 x 5 pixels), K = 576 to 6912.
CUDA_CONV_SHAPES = [(4, 64, 64, 192, 192), (2, 32, 32, 384, 384), (2, 16, 16, 384, 576),
                    (3, 12, 20, 64, 128), (2, 8, 8, 768, 768), (5, 8, 8, 128, 64),
                    (1, 3, 5, 64, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", CUDA_CONV_SHAPES)
def test_cuda_tf32x3_conv_matches_reference(n, h, w, cin, cout):
    """y and the dgrad through the 3xTF32 kernel, counted, bit-equal when
    repeated, within CONV_RTOL of the plain version."""
    _cuda()
    x, wt, g = (a.cuda() for a in _conv_inputs(n, h, w, cin, cout, seed=5))
    w_rot = wt.flip(0, 1).transpose(2, 3)
    before = dict(port_conv.conv3x3_pallas.launches_by_design)
    got = [port_conv.conv3x3_pallas(x, wt), port_conv.conv3x3_pallas(g, w_rot)]
    again = port_conv.conv3x3_pallas(x, wt)
    torch.cuda.synchronize()
    before["tf32x3"] += 3
    assert port_conv.conv3x3_pallas.launches_by_design == before
    assert torch.equal(got[0], again), "repeat not bit-equal"
    for name, a, b in zip(("y", "dx"), got, (port_conv.conv3x3_reference(x, wt),
                                             port_conv.conv3x3_reference(g, w_rot))):
        assert _rel(a, b) <= CONV_RTOL, name


# Both padded head dims (32, 64; D = 8, 16, 40 zero-filled by TMA), a ragged
# T (a masked key tile, an idle warpgroup), T = 1024 (32 streamed tiles),
# T = 64 (one idle warpgroup) and the classifier's and LDM's shapes.
CUDA_P5_SHAPES = [(4, 256, 9, 64), (16, 256, 16, 32), (2, 256, 8, 16), (3, 256, 5, 8),
                  (2, 256, 3, 40), (2, 136, 2, 32), (2, 1024, 2, 24), (1, 200, 3, 64),
                  (2, 64, 3, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", CUDA_P5_SHAPES)
def test_cuda_p5_tf32x3_backward_matches_reference(b, t, h, d):
    """Every shape through the 3xTF32 pair, counted, bit-equal when
    repeated, within BWD_RTOL of the plain version in each of dq, dk and
    dv."""
    _cuda()
    f5, g = (a.cuda() for a in _f5(b, t, h, d, seed=8))
    out, lse = flash_attention_p5_reference(f5)
    before = dict(flash_attention_p5_bwd.launches_by_design)
    got = flash_attention_p5_bwd(f5, out, lse, g)
    again = flash_attention_p5_bwd(f5, out, lse, g)
    torch.cuda.synchronize()
    before["tf32x3"] += 2
    assert flash_attention_p5_bwd.launches_by_design == before
    assert torch.equal(got, again), "repeat not bit-equal"
    want = flash_attention_p5_bwd_reference(f5, out, lse, g)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert _rel(got[:, i], want[:, i]) <= BWD_RTOL, name


@pytest.mark.cuda
def test_cuda_autograd_takes_the_tf32x3_p5_backward():
    """The classifier's 16 px blocks (576 score tiles) through autograd:
    the backward runs the pair, within BWD_RTOL of the plain version."""
    _cuda()
    f5, g = (a.cuda() for a in _f5(4, 256, 9, 64, seed=9))
    x = f5.clone().requires_grad_(True)
    before = dict(flash_attention_p5_bwd.launches_by_design)
    (flash_attention_p5(x) * g).sum().backward()
    torch.cuda.synchronize()
    before["tf32x3"] += 1
    assert flash_attention_p5_bwd.launches_by_design == before
    out, lse = flash_attention_p5_reference(f5)
    want = flash_attention_p5_bwd_reference(f5, out, lse, g)
    for i in range(3):
        assert _rel(x.grad[:, i], want[:, i]) <= BWD_RTOL
