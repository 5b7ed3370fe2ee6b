"""The general forward's f32 design on the tensor cores, "tf32x3"
(vaw_torch/ops/csrc/flash_fwd.cu: flash_fwd_tf32x3): which calls take it,
and its numerics, emulated on the CPU, against the plain version and the
JAX package's _flash forward (Pallas in interpret mode).

The kernel takes every f32 product as three TF32 passes. Each f32 operand
is x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero:
the bits plus 0x1000, the low 13 cleared), and lo = x - hi, exact in f32,
rounded to TF32 in turn; a product is lo.hi + hi.lo + hi.hi with f32 sums.
``tf32x3_attention`` below repeats that split, the kernel's key tiles (64
keys up to D = 64, 32 above) and its online softmax in the log2 domain, in
plain torch.

Tolerances are those the kernel is held to on the card (chip_smoke.py:
ATOL[float32] 2e-5 on o, LSE_ATOL 1e-4 on lse): the emulation must meet
them before the card does, against both references, at the fused checks'
T x D grid (B = 2, H = 4) and at REPA's teacher shape cut to B = 2. A
single TF32 pass does not meet them, so the test can tell the two apart.

JAX is imported inside the tests that compare with it; the card's tests
(marked ``cuda``) hold the kernel itself to the plain version.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    KERNEL_DESIGNS,
    flash_attention,
    flash_attention_fused,
    flash_attention_fused_reference,
    flash_attention_fwd,
    flash_attention_reference,
    flash_fused_fwd_design,
    flash_fwd_design,
)

# The fused-forward checks' grid (chip_smoke.py: FUSED_T, FUSED_D) and REPA's
# frozen teacher (DINOv2-B/14 at 224 px: 257 tokens, 12 heads of 64).
FUSED_T = (64, 256, 257, 1024)
FUSED_D = (40, 64, 72, 128)
TEACHER = (2, 257, 12, 64)
ATOL, LSE_ATOL = 2e-5, 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (hopper_common.cuh:tf32_hi): the bits plus 0x1000,
    the low 13 cleared, so the sign, exponent and top ten mantissa bits are
    x's to nearest, ties away from zero."""
    return ((x.view(torch.int32) + 4096) & -8192).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 passes: lo.hi + hi.lo + hi.hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 pass (what the kernel must not do)."""
    return _tf32(a) @ _tf32(b)


def tf32x3_attention(q, k, v, scale=None, mm=_mm3):
    """The kernel's arithmetic on [B, T, H, D] f32 q, k and v: raw scores
    by `mm`, key tiles of 64 (32 for D > 64), the running max of the scaled
    scores in the log2 domain, P = exp2(s * scale * log2(e) - m), P.V by
    `mm`. Returns (o [B, Tq, H, D], lse [B*H, Tq])."""
    b, tq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kt = 32 if d > 64 else 64
    qf, kf, vf = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, t, d]
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, h, tq, 1), -math.inf)
    l = torch.zeros((b, h, tq, 1))
    o = torch.zeros((b, h, tq, d))
    for k0 in range(0, k.shape[1], kt):
        s = mm(qf, kf[:, :, k0:k0 + kt].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, vf[:, :, k0:k0 + kt])
        m = m_new
    lse = (m + torch.log2(l)) * math.log(2.0)
    return (o / l).transpose(1, 2).contiguous(), lse.reshape(b * h, tq)


def _inputs(b, tq, tk, h, d, seed=0):
    """Unit normals, as chip_smoke.py draws its kernel inputs."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for t in (tq, tk, tk))


def _jax_forward(q, k, v):
    """The JAX package's _flash forward (o and lse) on [B, T, H, D] arrays."""
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    b, tq, h, d = q.shape
    dmajor = [jnp.asarray(x).transpose(0, 2, 3, 1).reshape(b * h, d, x.shape[1])
              for x in (q, k, v)]
    out, res = jax_flash._flash_fwd(*dmajor, 1.0 / math.sqrt(d))
    o = np.asarray(out).reshape(b, h, d, tq).transpose(0, 3, 1, 2)
    return o, np.asarray(res[4])[:, :tq]


SHAPES = [(2, t, t, 4, d) for t in FUSED_T for d in FUSED_D] + [
    (TEACHER[0], TEACHER[1], TEACHER[1], TEACHER[2], TEACHER[3]), (2, 77, 300, 3, 32)]


@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES)
def test_split_holds_the_f32_tolerance(b, tq, tk, h, d):
    """The emulated kernel within ATOL (o) and LSE_ATOL (lse) of the plain
    version and of the JAX package's Pallas forward."""
    q, k, v = _inputs(b, tq, tk, h, d, seed=d + tq)
    o, lse = tf32x3_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    want_o, want_lse = flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    assert (o - want_o).abs().max().item() <= ATOL
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL
    jax_o, jax_lse = _jax_forward(q, k, v)
    np.testing.assert_allclose(o.numpy(), jax_o, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jax_lse.reshape(b * h, tq), atol=LSE_ATOL,
                               rtol=0)


def test_one_tf32_pass_misses_the_tolerance():
    """One TF32 pass a product keeps about three digits: at the teacher's
    shape its o is far outside ATOL, so the three-pass split is what holds
    the tolerance."""
    b, t, h, d = TEACHER
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, t, t, h, d, seed=1))
    want, _ = flash_attention_reference(q, k, v)
    one, _ = tf32x3_attention(q, k, v, mm=_mm1)
    three, _ = tf32x3_attention(q, k, v)
    assert (one - want).abs().max().item() > 10 * ATOL
    assert (three - want).abs().max().item() <= ATOL


def test_split_is_exact_and_tf32_wide():
    """hi + (x - hi) is x bit for bit; hi and lo carry no bit below TF32's
    ten mantissa bits; hi is x to 2^-11 and hi + lo is x to 2^-22."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096).astype(np.float32))
    hi = _tf32(x)
    assert torch.equal(hi + (x - hi), x)
    lo = _tf32(x - hi)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 8191).any()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("dtype,d,scale,views,design", [
    (torch.float32, 8, 0.3, "mapped", "tf32x3"),
    (torch.float32, 32, 32 ** -0.5, "mapped", "tf32x3"),
    (torch.float32, 64, 0.125, "mapped", "tf32x3"),
    (torch.float32, 128, 0.3, "mapped", "tf32x3"),
    (torch.float32, 136, 0.3, "mapped", "fma"),
    (torch.float32, 64, -0.3, "mapped", "fma"),
    (torch.float32, 64, 0.0, "mapped", "fma"),
    (torch.float32, 64, 0.125, "stride0", "fma"),
    (torch.bfloat16, 64, 0.125, "mapped", "wgmma"),
    (torch.bfloat16, 128, 0.3, "mapped", "wgmma"),
    (torch.bfloat16, 136, 0.3, "mapped", "mma_sync"),
    (torch.bfloat16, 64, -0.3, "mapped", "mma_sync"),
    (torch.bfloat16, 64, 0.125, "stride0", "mma_sync")])
def test_general_forward_design(dtype, d, scale, views, design):
    """f32 with D <= 128, scale > 0 and views TMA maps takes tf32x3 (at
    T = 1024, above the crossover, TF32X3_MIN_TILES), other f32 calls the
    FMA kernel; bf16 keeps its rule."""
    q = torch.zeros(2, 1024, 4, d, dtype=dtype)
    k = q if views == "mapped" else torch.zeros(2, 1024, 1, d, dtype=dtype).expand(
        2, 1024, 4, d)
    assert flash_fwd_design(dtype, d, scale, (q, k, k)) == design


@pytest.mark.parametrize("dtype,scale,design", [
    (torch.float32, 0.125, "tf32x3"), (torch.float32, -1.0, "fma"),
    (torch.float32, 0.0, "fma"), (torch.bfloat16, 0.125, "wgmma"),
    (torch.bfloat16, -1.0, "mma_sync")])
def test_fused_forward_design(dtype, scale, design):
    """The fused forward's f32 calls with scale > 0 go to tf32x3 on the
    packed row's views; bf16 to the general wgmma forward on those views
    (the general mma.sync forward at scale <= 0)."""
    assert design in KERNEL_DESIGNS
    for d in (8, 40, 64, 128):
        assert flash_fused_fwd_design(dtype, d, scale) == design


def test_fused_forward_counts_by_design_only_on_the_card():
    """On the CPU the fused forward runs its plain version and counts no
    launch, in all or by kernel."""
    before = (flash_attention_fused.launches, dict(flash_attention_fused.launches_by_design))
    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 17, 3 * 2 * 8))
                           .astype(np.float32))
    o, lse = flash_attention_fused(qkv, 2)
    want_o, want_lse = flash_attention_fused_reference(qkv, 2)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert (flash_attention_fused.launches,
            flash_attention_fused.launches_by_design) == before
    assert set(before[1]) == set(KERNEL_DESIGNS)


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


# Every padded head dim (32, 64, 128; D = 8, 24, 40, 96 zero-filled by
# TMA), ragged T (a last work item with an idle warpgroup), Tq != Tk both
# ways, and the teacher's shape at a cut batch.
CUDA_SHAPES = [(2, 136, 136, 2, 8), (2, 258, 258, 2, 24), (2, 136, 136, 4, 32),
               (1, 258, 258, 2, 40), (4, 257, 257, 12, 64), (2, 77, 300, 3, 32),
               (1, 300, 77, 2, 64), (1, 258, 258, 2, 96), (1, 136, 136, 2, 128),
               (2, 1024, 1024, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,packed", [
    (*shape, packed) for shape in CUDA_SHAPES
    for packed in ((False, True) if shape[1] == shape[2] else (False,))])
def test_cuda_tf32x3_matches_reference(b, tq, tk, h, d, packed, monkeypatch):
    _cuda()
    # Every shape through the kernel, those below the crossover too.
    monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", 0)
    q, k, v = (torch.from_numpy(x).cuda() for x in _inputs(b, tq, tk, h, d, seed=5))
    if packed:
        q, k, v = torch.stack([q, k, v], dim=2).unbind(2)
    assert flash_fwd_design(torch.float32, d, d ** -0.5, (q, k, v)) == "tf32x3"
    before = dict(flash_attention.launches_by_design)
    out, lse = flash_attention_fwd(q, k, v)
    again, _ = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    before["tf32x3"] += 2
    assert flash_attention.launches_by_design == before
    assert torch.equal(out, again), "repeat not bit-equal"
    want, want_lse = flash_attention_reference(q, k, v)
    assert (out - want).abs().max().item() <= ATOL
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(4, 257, 12, 64), (2, 64, 4, 40), (2, 300, 2, 128)])
def test_cuda_fused_f32_takes_tf32x3(b, t, h, d, monkeypatch):
    _cuda()
    monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", 0)
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * d)).astype(np.float32)).cuda()
    before = dict(flash_attention_fused.launches_by_design)
    o, lse = flash_attention_fused(qkv, h)
    torch.cuda.synchronize()
    before["tf32x3"] += 1
    assert flash_attention_fused.launches_by_design == before
    want, want_lse = flash_attention_fused_reference(qkv, h)
    assert (o - want).abs().max().item() <= ATOL
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL
