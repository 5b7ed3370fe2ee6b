"""The f32 backward designs on the tensor cores, "tf32x3": the general
attention backward's pair (vaw_torch/ops/csrc/flash_bwd.cu:
flash_bwd_dq_tf32x3, flash_bwd_dkdv_tf32x3) and the conv's filter gradient
(vaw_torch/ops/csrc/conv3x3_wgrad.cu: conv3x3_wgrad_tf32x3): which calls
take them, and their numerics, emulated on the CPU, against the plain
versions and the JAX package's Pallas kernels (the attention backward of
_flash and conv3x3_wgrad_pallas, in interpret mode).

Each kernel takes every f32 product as three TF32 passes. Each f32 operand
is x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero:
the bits plus 0x1000, the low 13 cleared), and lo = x - hi, exact in f32,
rounded to TF32 in turn; a product is lo.hi + hi.lo + hi.hi with f32 sums.
``tf32x3_attention_bwd`` repeats that split on the backward's five products
(S = q k^T, dP = dout v^T, dV = P^T dout, dK = dS^T q, dQ = dS k) with P
from lse in the log2 domain, and ``tf32x3_wgrad`` on the wgrad's nine tap
products, in plain torch.

Tolerances are those the kernels are held to on the card (chip_smoke.py:
BWD_RTOL[float32] 1e-4 and WGRAD_RTOL[float32] 1e-4, relative to the
largest gradient value): the emulation must meet them before the card does,
against both references, at the classifier's three attention shapes cut to
B = 1-2, a Tq != Tk case, and a wgrad with 8192 pixels an element. One TF32
pass misses each by ten times more, so the tests tell the two apart.

The f32 calls below ``TF32X3_MIN_TILES`` score tiles keep the FMA kernels,
in both directions of the general attention and in the fused forward and
backward; at or above it the fused backward's f32 calls with D <= 64 run the
pair on the packed row's views, whose arithmetic the JAX package's _flash_p6
backward is held to below.

JAX is imported inside the tests that compare with it; the card's tests
(marked ``cuda``) hold the kernels themselves to the plain versions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

from vaw_torch.ops import conv2d as port_conv
from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    KERNEL_DESIGNS,
    TF32X3_MIN_TILES,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fused_bwd_reference,
    flash_attention_reference,
    flash_bwd_design,
    flash_fused_bwd_design,
    flash_fused_fwd_design,
    flash_fwd_design,
    score_tiles,
)

BWD_RTOL = 1e-4
WGRAD_RTOL = 1e-4
# The classifier's f32 attention (chip_smoke.py: CLF_GENERAL_F32) cut to a
# small batch: its 32 px blocks, its 8 px blocks and its attention pool;
# then Tq != Tk with a head dim of 32.
BWD_SHAPES = [(1, 1024, 1024, 6, 64), (2, 64, 64, 12, 64), (2, 65, 65, 12, 64),
              (2, 77, 300, 3, 32)]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (hopper_common.cuh:tf32_hi): the bits plus 0x1000,
    the low 13 cleared."""
    return ((x.view(torch.int32) + 4096) & -8192).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' three TF32 passes: lo.hi + hi.lo + hi.hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 pass (what the kernels must not do)."""
    return _tf32(a) @ _tf32(b)


def tf32x3_attention_bwd(q, k, v, out, lse, dout, scale=None, mm=_mm3):
    """The tf32x3 pair's arithmetic on [B, T, H, D] f32 tensors: raw scores
    S = q k^T by `mm`, P = exp2(S * scale * log2(e) - lse * log2(e)), delta =
    rowsum(dout * out) in f32, dP = dout v^T, dS = P (dP - delta), dV = P^T
    dout, dK = (dS^T q) * scale and dQ = (dS k) * scale, every product by
    `mm`. Returns (dq, dk, dv)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, gf = (x.transpose(1, 2) for x in (q, k, v, out, dout))
    b, h, tq, _ = qf.shape
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    lse2 = lse.reshape(b, h, tq, 1) * math.log2(math.e)
    p = torch.exp2(mm(qf, kf.transpose(-1, -2)) * scale_log2 - lse2)
    delta = (gf * of).sum(-1, keepdim=True)
    ds = p * (mm(gf, vf.transpose(-1, -2)) - delta)
    dv = mm(p.transpose(-1, -2), gf)
    dk = mm(ds.transpose(-1, -2), qf) * scale
    dq = mm(ds, kf) * scale
    return tuple(x.transpose(1, 2).contiguous() for x in (dq, dk, dv))


def tf32x3_wgrad(x, g, mm=_mm3):
    """The tf32x3 wgrad's arithmetic: dw[dy, dx] = the shifted x[N*H*W,
    Cin]^T @ g[N*H*W, Cout] by `mm`, zero outside the image."""
    gf = g.reshape(-1, g.shape[-1])
    dw = torch.empty((3, 3, x.shape[-1], g.shape[-1]))
    for dy, dx, tap in port_conv._taps(x):
        dw[dy, dx] = mm(tap.t(), gf)
    return dw


def _attention_inputs(b, tq, tk, h, d, seed=0):
    """Unit normals, as chip_smoke.py draws its kernel inputs: q, k, v and
    the incoming gradient."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
                 for t in (tq, tk, tk, tq))


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def _jax_grads(q, k, v, g):
    """dq, dk, dv of the JAX package's flash_attention, whose backward is
    _flash's Pallas kernel (interpret mode on the CPU)."""
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    _, vjp = jax.vjp(jax_flash.flash_attention, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    return [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(g.numpy()))]


@pytest.mark.parametrize("b,tq,tk,h,d", BWD_SHAPES)
def test_backward_split_holds_the_f32_tolerance(b, tq, tk, h, d):
    """The emulated pair within BWD_RTOL of the plain version and of the JAX
    package's Pallas backward, in each of dq, dk and dv."""
    q, k, v, g = _attention_inputs(b, tq, tk, h, d, seed=tq + d)
    out, lse = flash_attention_reference(q, k, v)
    got = tf32x3_attention_bwd(q, k, v, out, lse, g)
    plain = flash_attention_bwd_reference(q, k, v, out, lse, g)
    jax_grads = _jax_grads(q, k, v, g)
    for name, x, p, j in zip(("dq", "dk", "dv"), got, plain, jax_grads):
        assert _rel(x, p) <= BWD_RTOL, name
        assert _rel(x, j) <= BWD_RTOL, name


def test_packed_row_split_matches_pallas_p6_backward():
    """B2's layout through the pair's arithmetic: q, k, v, out and dout as
    views of the packed [B, T, 3*H*D] row and its [B, T, H*D] output, dq,
    dk and dv stacked into one dqkv laid out like the row, within BWD_RTOL
    of the JAX package's _flash_p6 backward (_bwd_kernel_p6, interpret mode)
    and of the fused plain version."""
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    b, t, h, d = 2, 256, 2, 64
    rng = np.random.default_rng(4)
    f = (rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32)
    g = rng.standard_normal((b, t, h * d)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    assert jax_flash.flash_fused_supported(b, h, d, t)
    _, res = jax_flash._flash_p6_fwd(jnp.asarray(f), h, scale)
    (want,) = jax_flash._flash_p6_bwd(h, scale, res, jnp.asarray(g))
    qkv2d, out, lse = (torch.from_numpy(np.array(r)) for r in res)
    dout = torch.from_numpy(g)
    views = qkv2d.view(b, t, 3, h, d).unbind(2)
    grads = tf32x3_attention_bwd(*views, out.view(b, t, h, d), lse, dout.view(b, t, h, d))
    got = torch.stack(grads, dim=2).reshape(b, t, 3 * h * d)
    assert _rel(got, torch.from_numpy(np.array(want))) <= BWD_RTOL
    assert _rel(got, flash_attention_fused_bwd_reference(qkv2d, out, lse, dout, h)) <= BWD_RTOL


def test_one_tf32_pass_misses_the_backward_tolerance():
    """One TF32 pass a product keeps about three digits: at the classifier's
    T = 1024 shape its gradients lie ten times further from the plain
    version than the three-pass split's."""
    q, k, v, g = _attention_inputs(*BWD_SHAPES[0], seed=1)
    out, lse = flash_attention_reference(q, k, v)
    plain = flash_attention_bwd_reference(q, k, v, out, lse, g)
    three = max(_rel(x, p) for x, p in
                zip(tf32x3_attention_bwd(q, k, v, out, lse, g), plain))
    one = max(_rel(x, p) for x, p in
              zip(tf32x3_attention_bwd(q, k, v, out, lse, g, mm=_mm1), plain))
    assert three <= BWD_RTOL
    assert one > 10 * three and one > BWD_RTOL


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                             interpret=True))


# A wgrad with many pixels an element (8192) at Cin and Cout multiples of 64,
# the shapes the tf32x3 wgrad takes.
WGRAD_SHAPE = (8, 32, 32, 64, 64)


def _wgrad_inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, h, w, cout)).astype(np.float32)))


def test_wgrad_split_holds_the_f32_tolerance(interpret):
    """The emulated wgrad within WGRAD_RTOL of the plain version and of the
    JAX package's conv3x3_wgrad_pallas (interpret mode)."""
    import jax.numpy as jnp

    from vaw_tpu.ops import conv2d as jax_conv

    x, g = _wgrad_inputs(*WGRAD_SHAPE)
    got = tf32x3_wgrad(x, g)
    assert _rel(got, port_conv.conv3x3_wgrad_reference(x, g)) <= WGRAD_RTOL
    want = torch.from_numpy(np.array(jax_conv.conv3x3_wgrad_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(g.numpy()))))
    assert want.shape == got.shape
    assert _rel(got, want) <= WGRAD_RTOL


def test_one_tf32_pass_misses_the_wgrad_tolerance():
    x, g = _wgrad_inputs(*WGRAD_SHAPE, seed=1)
    plain = port_conv.conv3x3_wgrad_reference(x, g)
    three = _rel(tf32x3_wgrad(x, g), plain)
    one = _rel(tf32x3_wgrad(x, g, mm=_mm1), plain)
    assert three <= WGRAD_RTOL
    assert one > 10 * three and one > WGRAD_RTOL


# ------------------------------------------------------------------ routing


def _views(b, tq, tk, h, d, n=3, dtype=torch.float32):
    """q and then k-shaped [B, T, H, D] views on the meta device (strides
    and base TMA maps, no memory): n of them, the first [B, Tq, H, D]."""
    q = torch.empty((b, tq, h, d), dtype=dtype, device="meta")
    k = torch.empty((b, tk, h, d), dtype=dtype, device="meta")
    return (q,) + (k,) * (n - 1)


@pytest.mark.parametrize("d,scale,design", [
    (8, 0.3, "tf32x3"), (32, 32 ** -0.5, "tf32x3"), (40, 0.2, "tf32x3"),
    (64, 0.125, "tf32x3"), (72, 0.125, "fma"), (128, 0.3, "fma"), (64, -0.3, "fma"),
    (64, 0.0, "fma")])
def test_f32_backward_design_by_head_dim_and_scale(d, scale, design):
    """f32 with D <= 64 and scale > 0 takes the 3xTF32 pair, with no views
    and with mapped views above the crossover; other f32 calls the FMA
    kernels."""
    assert flash_bwd_design(torch.float32, d, scale) == design
    assert flash_bwd_design(torch.float32, d, scale, _views(4, 1024, 1024, 6, d, 6)) == design


def test_f32_backward_design_needs_mapped_views():
    q = torch.zeros(2, 16, 4, 64)
    k = torch.zeros(2, 16, 1, 64).expand(2, 16, 4, 64)
    assert flash_bwd_design(torch.float32, 64, 0.125, (q, k, k, q, q, q)) == "fma"


@pytest.mark.parametrize("b,tq,tk,h", [
    (4, 1024, 1024, 6), (4, 64, 64, 12), (4, 65, 65, 12), (16, 64, 64, 32),
    (16, 256, 256, 9), (16, 64, 64, 12), (16, 1024, 1024, 8), (16, 258, 258, 16),
    (256, 257, 257, 12), (2, 77, 300, 3)])
def test_f32_crossover_by_score_tiles(b, tq, tk, h):
    """Below TF32X3_MIN_TILES score tiles an f32 call takes the FMA kernels
    in the general forward and backward and in the fused forward; at or
    above it, the 3xTF32 designs. bf16 calls keep wgmma at every size."""
    tiles = score_tiles(b, tq, tk, h)
    assert tiles == b * h * math.ceil(tq / 64) * math.ceil(tk / 64)
    want = "tf32x3" if tiles >= TF32X3_MIN_TILES else "fma"
    assert flash_fwd_design(torch.float32, 64, 0.125, _views(b, tq, tk, h, 64)) == want
    assert flash_bwd_design(torch.float32, 64, 0.125, _views(b, tq, tk, h, 64, 6)) == want
    if tq == tk:
        assert flash_fused_fwd_design(torch.float32, 64, 0.125,
                                      _views(b, tq, tk, h, 64)) == want
    bf16 = _views(b, tq, tk, h, 64, 6, torch.bfloat16)
    assert flash_fwd_design(torch.bfloat16, 64, 0.125, bf16[:3]) == "wgmma"
    assert flash_bwd_design(torch.bfloat16, 64, 0.125, bf16) == "wgmma"


def test_crossover_sits_between_the_classifiers_shapes():
    """The classifier's 8 px blocks and its pool stay on FMA, its 32 px
    blocks take tf32x3 (chip_smoke.py: CLF_GENERAL_F32)."""
    assert score_tiles(4, 65, 65, 12) < TF32X3_MIN_TILES <= score_tiles(4, 1024, 1024, 6)


@pytest.mark.parametrize("d", [8, 40, 64, 72, 128])
def test_fused_backward_stays_on_fma_in_f32(d):
    """B2's f32 backward stays on the fused FMA kernels for D > 64, a scale
    <= 0 and calls below TF32X3_MIN_TILES score tiles; at or above it with
    D <= 64 it takes the general pair's 3xTF32 design on the packed row's
    views (DiT-B/2 at batch 256), as does a call ruled on D and scale
    alone. bf16 keeps its own rule: the wgmma pair up to D = 128."""
    small, large = _views(1, 256, 256, 2, d, 6), _views(256, 256, 256, 12, d, 6)
    tf32x3 = "tf32x3" if d <= 64 else "fma"
    assert flash_fused_bwd_design(torch.float32, d, d ** -0.5, small) == "fma"
    assert flash_fused_bwd_design(torch.float32, d, -0.3, large) == "fma"
    assert flash_fused_bwd_design(torch.float32, d, d ** -0.5, large) == tf32x3
    assert flash_fused_bwd_design(torch.float32, d, d ** -0.5) == tf32x3
    assert flash_fused_bwd_design(torch.bfloat16, d, d ** -0.5) == (
        "wgmma" if d <= 128 else "mma_sync")


@pytest.mark.parametrize("shape,cout,dtype,design", [
    ((16, 64, 64, 192), 192, torch.float32, "tf32x3"),
    ((64, 32, 32, 384), 384, torch.float32, "tf32x3"),
    ((64, 16, 16, 384), 576, torch.float32, "tf32x3"),
    ((3, 12, 20, 64), 128, torch.float32, "tf32x3"),
    ((64, 64, 64, 3), 192, torch.float32, "fma"),       # the stem
    ((64, 64, 64, 192), 3, torch.float32, "fma"),       # the head
    ((2, 8, 8, 96), 64, torch.float32, "fma"),          # Cin % 64 != 0
    ((2, 8, 8, 64), 96, torch.float32, "fma"),          # Cout % 64 != 0
    ((16, 64, 64, 192), 192, torch.bfloat16, "wgmma")])
def test_wgrad_design_in_f32(shape, cout, dtype, design):
    assert port_conv.conv3x3_wgrad_design(shape, cout, dtype) == design
    assert design in port_conv.CONV_DESIGNS


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (64, 64, 64, 192, 192), (16, 64, 64, 192, 192), (64, 32, 32, 384, 384),
    (64, 32, 32, 192, 384), (64, 16, 16, 384, 576), (64, 16, 16, 576, 576),
    (64, 8, 8, 768, 768), (3, 12, 20, 64, 128), (5, 8, 8, 128, 64), (1, 3, 5, 64, 192)])
def test_tf32x3_wgrad_plan_covers_every_pixel_once(n, h, w, cin, cout):
    """The tf32x3 plan: 32-pixel boxes that tile every image, every box in
    exactly one split, none empty, at most one wave of 132 blocks unless
    the tiles alone exceed it; BN is 96 or 64, one that divides Cout, the
    one whose blocks fill the waves of one block an SM better (96 on a
    tie)."""
    bni, bh, bw, bn, splits, per = port_conv.conv3x3_wgrad_plan(n, h, w, cin, cout,
                                                                "tf32x3")
    assert bni * bh * bw == 32
    boxes = -(-n // bni) * -(-h // bh) * -(-w // bw)
    assert (splits - 1) * per < boxes <= splits * per
    tiles = 3 * (cin // 64) * (cout // bn)
    assert tiles * splits <= max(132, tiles)

    def fill(b):
        t = 3 * (cin // 64) * (cout // b)
        blocks = t * max(1, min(132 // t, boxes))
        return blocks / (math.ceil(blocks / 132) * 132)

    assert bn in (96, 64) and cout % bn == 0
    if cout % 96 == 0:
        assert fill(bn) == max(fill(96), fill(64)) and (bn == 96 or fill(64) > fill(96))
    covered = set()
    for box in range(boxes):
        w0 = (box % -(-w // bw)) * bw
        h0 = ((box // -(-w // bw)) % -(-h // bh)) * bh
        n0 = (box // (-(-w // bw) * -(-h // bh))) * bni
        covered |= {(i, y, x) for i in range(n0, min(n0 + bni, n))
                    for y in range(h0, min(h0 + bh, h)) for x in range(w0, min(w0 + bw, w))}
    assert len(covered) == n * h * w


def test_cpu_calls_count_no_tf32x3_launch():
    """On the CPU the wrappers run their plain versions and count nothing,
    in all or by kernel."""
    before = (flash_attention_bwd.launches, dict(flash_attention_bwd.launches_by_design),
              port_conv.conv3x3_wgrad_pallas.launches,
              dict(port_conv.conv3x3_wgrad_pallas.launches_by_design))
    q, k, v, g = _attention_inputs(1, 64, 64, 2, 64)
    out, lse = flash_attention_reference(q, k, v)
    got = flash_attention_bwd(q, k, v, out, lse, g)
    for x, w in zip(got, flash_attention_bwd_reference(q, k, v, out, lse, g)):
        assert torch.equal(x, w)
    x, gw = _wgrad_inputs(1, 8, 8, 64, 64)
    assert torch.equal(port_conv.conv3x3_wgrad_pallas(x, gw),
                       port_conv.conv3x3_wgrad_reference(x, gw))
    assert (flash_attention_bwd.launches, flash_attention_bwd.launches_by_design,
            port_conv.conv3x3_wgrad_pallas.launches,
            port_conv.conv3x3_wgrad_pallas.launches_by_design) == before
    assert set(before[1]) == set(KERNEL_DESIGNS)
    assert "tf32x3" in before[3]


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


# Both padded head dims (32, 64; D = 8, 40 zero-filled by TMA), ragged Tq
# and Tk (idle warpgroups, a ragged key tile), Tq != Tk both ways and the
# classifier's shapes.
CUDA_BWD_SHAPES = [(1, 1024, 1024, 6, 64), (4, 64, 64, 12, 64), (4, 65, 65, 12, 64),
                   (2, 77, 300, 3, 32), (1, 300, 77, 2, 64), (2, 136, 136, 2, 8),
                   (2, 257, 257, 4, 40), (16, 256, 256, 9, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,packed", [
    (*shape, packed) for shape in CUDA_BWD_SHAPES
    for packed in ((False, True) if shape[1] == shape[2] else (False,))])
def test_cuda_tf32x3_backward_matches_reference(b, tq, tk, h, d, packed, monkeypatch):
    """Every shape through the pair (the crossover set to 0), counted,
    bit-equal when repeated, within BWD_RTOL of the plain version."""
    _cuda()
    monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", 0)
    q, k, v, g = (x.cuda() for x in _attention_inputs(b, tq, tk, h, d, seed=5))
    grads = None
    if packed:
        q, k, v = torch.stack([q, k, v], dim=2).unbind(2)
        grads = torch.empty_like(torch.stack([q, k, v], dim=2)).unbind(2)
    out, lse = flash_attention_reference(q, k, v)
    assert flash_bwd_design(torch.float32, d, d ** -0.5, (q, k, v) * 2) == "tf32x3"
    before = dict(flash_attention_bwd.launches_by_design)
    got = [x.clone() for x in flash_attention_bwd(q, k, v, out, lse, g, grads=grads)]
    again = flash_attention_bwd(q, k, v, out, lse, g, grads=grads)
    torch.cuda.synchronize()
    before["tf32x3"] += 2
    assert flash_attention_bwd.launches_by_design == before
    assert all(torch.equal(x, y) for x, y in zip(got, again)), "repeat not bit-equal"
    for x, w in zip(got, flash_attention_bwd_reference(q, k, v, out, lse, g)):
        assert _rel(x, w) <= BWD_RTOL


@pytest.mark.cuda
def test_cuda_autograd_takes_tf32x3_above_the_crossover():
    _cuda()
    q, k, v, g = (x.cuda() for x in _attention_inputs(1, 1024, 1024, 6, 64, seed=6))
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(flash_attention_bwd.launches_by_design)
    (flash_attention(*xs) * g).sum().backward()
    torch.cuda.synchronize()
    before["tf32x3"] += 1
    assert flash_attention_bwd.launches_by_design == before
    out, lse = flash_attention_reference(q, k, v)
    for x, w in zip(xs, flash_attention_bwd_reference(q, k, v, out, lse, g)):
        assert _rel(x.grad, w) <= BWD_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (16, 64, 64, 192, 192), (2, 32, 32, 384, 384), (2, 16, 16, 384, 576),
    (3, 12, 20, 64, 128), (2, 8, 8, 768, 768), (5, 8, 8, 128, 64)])
def test_cuda_tf32x3_wgrad_matches_reference(n, h, w, cin, cout):
    _cuda()
    x, g = (t.cuda() for t in _wgrad_inputs(n, h, w, cin, cout, seed=7))
    before = dict(port_conv.conv3x3_wgrad_pallas.launches_by_design)
    dw = port_conv.conv3x3_wgrad_pallas(x, g)
    again = port_conv.conv3x3_wgrad_pallas(x, g)
    torch.cuda.synchronize()
    before["tf32x3"] += 2
    assert port_conv.conv3x3_wgrad_pallas.launches_by_design == before
    assert torch.equal(dw, again), "repeat not bit-equal"
    assert _rel(dw, port_conv.conv3x3_wgrad_reference(x, g)) <= WGRAD_RTOL
