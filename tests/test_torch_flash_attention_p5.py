"""Parity of the port's d-major packed attention (vaw_torch/ops/
flash_attention.py: flash_attention_p5, its plain versions and the p5 route
of flash_attention_packed) with the JAX package's _flash_p5, whose Pallas
kernels (_fwd_kernel_p5, _bwd_kernel_p5) run in interpret mode on the CPU,
as tests/test_ops.py:265-300 runs them. Inputs and incoming gradients come
from numpy with a fixed seed, at shapes the JAX gate admits: (B, T, H, D) =
(2, 256, 8, 16) and (4, 256, 9, 64), nine heads so that 8 does not divide
B*H.

Tolerances:
- o and lse against the Pallas forward: atol 2e-5 (tests/test_ops.py:286,
  f32 on both sides, different summation order);
- dqkv against the Pallas backward: atol 5e-4 (tests/test_ops.py:296);
- the plain backward against autograd of the plain forward: atol 1e-5 (the
  same f32 math, P from lse instead of softmax);
- the CUDA kernels against the plain versions on the card: forward f32 atol
  2e-5 and bf16 atol 1e-2 (one bf16 rounding of |o| < 2), lse atol 1e-4;
  backward f32 within 1e-4 and bf16 within 2e-2 of max|dqkv| (P and dS
  enter the tensor-core products as bf16 hi + lo, and each gradient is
  rounded once to bf16); a repeated backward is bit-equal (no atomics).

The kernels are chosen by the call (``flash_p5_fwd_design``,
``flash_p5_bwd_design``): in bf16 TMA + wgmma with scale > 0 (the backward
at every admitted D), mma.sync otherwise; the CPU tests check that choice and that
every bf16 p5 call of LDM takes wgmma both ways. The f32 rules (3xTF32; the
forward at or above the crossover) are checked in
tests/test_torch_f32_p5_tf32x3.py and tests/test_torch_f32_conv_p5bwd_tf32x3.py.

JAX is imported inside the tests that compare with it, so the CUDA cases
also collect on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    flash_attention_p5,
    flash_attention_p5_bwd,
    flash_attention_p5_bwd_reference,
    flash_attention_p5_fwd,
    flash_attention_p5_reference,
    flash_attention_packed,
    flash_attention_reference,
    flash_p5_bwd_design,
    flash_p5_fwd_design,
)

# (B, T, H, D), each admitted by the JAX gate
SHAPES = [(2, 256, 8, 16), (4, 256, 9, 64)]


def _inputs(b, t, h, d, seed=0):
    """f5 [B, 3, H, D, T] (q and k at 0.5, v at 1) and an incoming gradient
    g [B*H, D, T], from numpy."""
    rng = np.random.default_rng(seed)
    f5 = rng.standard_normal((b, 3, h, d, t)).astype(np.float32)
    f5[:, :2] *= 0.5
    g = rng.standard_normal((b * h, d, t)).astype(np.float32)
    return f5, g


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_forward_matches_pallas_interpret(b, t, h, d):
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    assert jax_flash._packed5_supported(b, h, d, t)
    f5, _ = _inputs(b, t, h, d)
    want_o, (_, _, want_lse) = jax_flash._flash_p5_fwd(jnp.asarray(f5), 0.3)
    got_o, got_lse = flash_attention_p5_fwd(torch.from_numpy(f5), 0.3)
    assert got_o.shape == (b * h, d, t) and got_lse.shape == (b * h, t)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_backward_matches_pallas_interpret(b, t, h, d):
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    f5, g = _inputs(b, t, h, d, seed=1)
    scale = 1.0 / np.sqrt(d)
    _, res = jax_flash._flash_p5_fwd(jnp.asarray(f5), scale)
    (want,) = jax_flash._flash_p5_bwd(scale, res, jnp.asarray(g))
    _, out, lse = (torch.from_numpy(np.array(r)) for r in res)
    got = flash_attention_p5_bwd(torch.from_numpy(f5), out, lse, torch.from_numpy(g))
    assert got.shape == f5.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_packed_entry_matches_jax_packed_pallas(b, t, h, d):
    """The port's packed entry at a p5 shape runs the p5 route (on the CPU
    its plain versions) and matches multi_head_attention_packed(qkv,
    use_pallas=True): o, the packed gradient and the d-major output."""
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops.attention import multi_head_attention_packed

    rng = np.random.default_rng(2)
    qkv = (rng.standard_normal((b, t, 3, h, d)) * 0.3).astype(np.float32)
    g = rng.standard_normal((b, t, h, d)).astype(np.float32)
    want_o = multi_head_attention_packed(jnp.asarray(qkv), use_pallas=True)
    want_g = jax.grad(lambda x: jnp.sum(
        multi_head_attention_packed(x, use_pallas=True) * g))(jnp.asarray(qkv))
    want_dm = multi_head_attention_packed(jnp.asarray(qkv), use_pallas=True,
                                          d_major_out=True)

    calls = []
    real = port_flash._FlashP5.apply
    x = torch.from_numpy(qkv).requires_grad_(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_flash._FlashP5, "apply",
                   lambda *a: calls.append(a[0].shape) or real(*a))
        out = flash_attention_packed(x)
        (out * torch.from_numpy(g)).sum().backward()
        dm = flash_attention_packed(x.detach(), d_major_out=True)
    assert calls == [(b, 3, h, d, t)] * 2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), atol=2e-5,
                               rtol=0)
    assert x.grad.shape == x.shape
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=5e-4, rtol=0)
    assert dm.shape == (b, h * d, t)
    np.testing.assert_allclose(dm.numpy(), np.asarray(want_dm), atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,t,h,d", [(2, 256, 2, 8), (1, 18, 2, 8), (1, 18, 2, 12)])
def test_router_honours_d_major_out_on_every_route(b, t, h, d):
    """p5, general-kernel and plain routes of multi_head_attention_packed:
    the d-major output is the [B, T, H, D] one laid out [B, H*D, T]."""
    from vaw_torch.ops.attention import multi_head_attention_packed

    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, t, 3, h, d)).astype(np.float32))
    out = multi_head_attention_packed(qkv)
    dm = multi_head_attention_packed(qkv, d_major_out=True)
    assert out.shape == (b, t, h, d) and dm.shape == (b, h * d, t)
    torch.testing.assert_close(dm, out.permute(0, 2, 3, 1).reshape(b, h * d, t),
                               rtol=0, atol=0)


def test_plain_p5_matches_the_general_plain_version():
    """The two plain versions compute one function on two layouts."""
    f5, _ = _inputs(2, 64, 3, 8, seed=3)
    x = torch.from_numpy(f5)
    o, lse = flash_attention_p5_reference(x, 0.41)
    q, k, v = (x[:, i].permute(0, 3, 1, 2) for i in range(3))  # [B, T, H, D]
    want_o, want_lse = flash_attention_reference(q, k, v, 0.41)
    np.testing.assert_allclose(o.reshape(2, 3, 8, 64).permute(0, 3, 1, 2).numpy(),
                               want_o.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6, rtol=0)


def test_bwd_reference_matches_autograd_of_plain_forward():
    f5, g = _inputs(2, 256, 3, 24, seed=4)
    x = torch.from_numpy(f5).requires_grad_(True)
    out, lse = flash_attention_p5_reference(x, 0.37)  # plain autograd graph
    (out * torch.from_numpy(g)).sum().backward()
    got = flash_attention_p5_bwd_reference(x.detach(), out.detach(), lse.detach(),
                                           torch.from_numpy(g), 0.37)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), atol=1e-5, rtol=0)


def test_cpu_launches_no_kernel():
    before = (flash_attention_p5.launches, flash_attention_p5_bwd.launches)
    f5, g = _inputs(1, 256, 2, 8, seed=5)
    x = torch.from_numpy(f5).requires_grad_(True)
    (flash_attention_p5(x) * torch.from_numpy(g)).sum().backward()
    assert x.grad is not None
    assert (flash_attention_p5.launches, flash_attention_p5_bwd.launches) == before


@pytest.mark.parametrize("dtype,scale,shape,design", [
    (torch.bfloat16, 32 ** -0.5, (2, 3, 8, 32, 256), "wgmma"),
    (torch.bfloat16, 0.3, (1, 3, 2, 8, 64), "wgmma"),
    (torch.bfloat16, -0.3, (16, 3, 16, 32, 256), "mma_sync"),
    (torch.bfloat16, 0.0, (2, 3, 8, 32, 256), "mma_sync"),
    (torch.float32, 32 ** -0.5, (2, 3, 8, 32, 256), "fma"),
    (torch.float32, -0.3, (16, 3, 16, 32, 256), "fma"),
    (torch.float32, 32 ** -0.5, (16, 3, 16, 32, 256), "tf32x3"),
    (torch.float32, 0.125, (4, 3, 9, 64, 256), "tf32x3"),
    (torch.float32, 0.125, (2, 3, 9, 64, 256), "fma"),
    (torch.float32, 128 ** -0.5, (16, 3, 4, 128, 256), "fma")])
def test_forward_design_is_chosen_by_the_call(dtype, scale, shape, design):
    """bf16 takes the TMA + wgmma kernel wherever the wrapper admits the
    shape and the scale is positive (its softmax takes the max on the raw
    scores), the mma.sync kernel otherwise; f32 the 3xTF32 kernel with a
    positive scale, D <= 64 and at least TF32X3_MIN_TILES score tiles (the
    classifier's (4, 256, 9, 64) has 576, LDM's gradient check 4096), the
    FMA kernel otherwise."""
    assert flash_p5_fwd_design(dtype, scale, shape) == design


@pytest.mark.parametrize("dtype,d,scale,design", [
    (torch.bfloat16, 32, 32 ** -0.5, "wgmma"), (torch.bfloat16, 64, 0.125, "wgmma"),
    (torch.bfloat16, 16, 0.25, "wgmma"), (torch.bfloat16, 8, 0.3, "wgmma"),
    (torch.bfloat16, 40, 0.3, "wgmma"), (torch.bfloat16, 72, 0.3, "wgmma"),
    (torch.bfloat16, 128, 128 ** -0.5, "wgmma"), (torch.bfloat16, 32, -0.3, "mma_sync"),
    (torch.bfloat16, 32, 0.0, "mma_sync"), (torch.float32, 32, 32 ** -0.5, "tf32x3"),
    (torch.float32, 128, -0.3, "fma")])
def test_backward_design_is_chosen_by_the_call(dtype, d, scale, design):
    """bf16 takes the TMA + wgmma backward at every admitted D with a
    positive scale (from 80 the dK/dV kernel gives dV and dK a warpgroup
    each), mma.sync otherwise; f32 the 3xTF32 pair for D <= 64 with a
    positive scale, the FMA kernels otherwise."""
    assert flash_p5_bwd_design(dtype, d, scale) == design


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_backward_counts_no_kernel_by_design(dtype):
    before = dict(flash_attention_p5_bwd.launches_by_design)
    f5, g = (torch.from_numpy(a).to(dtype) for a in _inputs(1, 64, 2, 8, seed=7))
    x = f5.requires_grad_(True)
    (flash_attention_p5(x) * g).sum().backward()
    assert x.grad.shape == x.shape
    assert flash_attention_p5_bwd.launches_by_design == before


def test_ldm_p5_calls_take_the_wgmma_kernel():
    """Every p5 call of one bf16 LDM forward (five at the 16x16 level, 16
    heads of 32, T = 256), recorded on the meta device, goes to wgmma in
    the forward and in the backward."""
    from vaw_torch.models import unet as port_unet

    calls = []

    def record(f5, scale):
        calls.append((tuple(f5.shape), f5.dtype, scale))
        b, _, h, d, t = f5.shape
        return f5.new_empty((b * h, d, t))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_flash, "flash_attention_p5", record)
        mp.setattr(port_flash._FlashPacked, "apply", lambda qkv, scale: qkv[:, :, 0])
        with torch.device("meta"):
            model = port_unet.LDM(num_classes=1000, in_channels=4, drop_label_prob=0.1,
                                  compute_dtype=torch.bfloat16)
            model(torch.empty(2, 32, 32, 4), torch.empty(2), torch.zeros(2, dtype=torch.long))
    assert [c[0] for c in calls] == [(2, 3, 16, 32, 256)] * 5
    assert {flash_p5_fwd_design(dtype, scale) for _, dtype, scale in calls} == {"wgmma"}
    assert {flash_p5_bwd_design(dtype, shape[3], scale)
            for shape, dtype, scale in calls} == {"wgmma"}


def test_cpu_forward_counts_no_kernel_by_design():
    before = dict(flash_attention_p5.launches_by_design)
    f5, _ = _inputs(1, 64, 2, 8, seed=4)
    flash_attention_p5_fwd(torch.from_numpy(f5).bfloat16())
    flash_attention_p5_fwd(torch.from_numpy(f5))
    assert flash_attention_p5.launches_by_design == before


def test_wrappers_reject_malformed_input():
    f5, g = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 8, seed=6))
    with pytest.raises(ValueError, match=r"\[B, 3, H, D, T\]"):
        flash_attention_p5_fwd(f5[:, :2])
    with pytest.raises(ValueError, match=r"\[B, 3, H, D, T\]"):
        flash_attention_p5_bwd(f5[0], g, g[:, 0], g)


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


# The gate's shapes (LDM's 16x16 level, the JAX test's, nine heads, D = 128),
# D = 8 and 40 (head dims that are not multiples of 16), a ragged T, a T
# past four key tiles, and D = 96 with T past one 128-query work item.
CUDA_SHAPES = [(8, 256, 16, 32), (4, 256, 9, 64), (2, 256, 8, 16), (2, 256, 4, 128),
               (3, 256, 5, 8), (2, 256, 3, 40), (2, 136, 2, 32), (2, 1024, 2, 24),
               (1, 200, 3, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d", CUDA_SHAPES)
def test_cuda_forward_kernel_matches_reference(b, t, h, d, dtype):
    _cuda()
    f5, _ = _inputs(b, t, h, d)
    x = torch.from_numpy(f5).cuda().to(dtype)
    before = flash_attention_p5.launches
    designs = dict(flash_attention_p5.launches_by_design)
    out, lse = flash_attention_p5_fwd(x)
    torch.cuda.synchronize()
    assert flash_attention_p5.launches == before + 1
    designs[flash_p5_fwd_design(dtype, d ** -0.5, x.shape)] += 1
    assert flash_attention_p5.launches_by_design == designs
    want, want_lse = flash_attention_p5_reference(x)
    atol = 2e-5 if dtype == torch.float32 else 1e-2
    assert out.dtype == dtype and out.shape == (b * h, d, t)
    assert (out.float() - want.float()).abs().max().item() <= atol
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(4, 256, 9, 64), (2, 136, 2, 32)])
def test_cuda_mma_sync_kernel_takes_a_negative_scale(b, t, h, d):
    _cuda()
    f5, _ = _inputs(b, t, h, d, seed=3)
    x = torch.from_numpy(f5).cuda().to(torch.bfloat16)
    before = flash_attention_p5.launches_by_design["mma_sync"]
    out, lse = flash_attention_p5_fwd(x, -0.2)
    torch.cuda.synchronize()
    assert flash_attention_p5.launches_by_design["mma_sync"] == before + 1
    want, want_lse = flash_attention_p5_reference(x, -0.2)
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,h,d", CUDA_SHAPES)
def test_cuda_backward_kernel_matches_reference(b, t, h, d, dtype, rtol):
    """Each shape through the kernels its call selects (counted by kernel),
    bit-equal when repeated."""
    _cuda()
    f5, g = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(b, t, h, d, seed=8))
    out, lse = flash_attention_p5_fwd(f5)
    before = flash_attention_p5_bwd.launches
    designs = dict(flash_attention_p5_bwd.launches_by_design)
    got = flash_attention_p5_bwd(f5, out, lse, g)
    again = flash_attention_p5_bwd(f5, out, lse, g)
    torch.cuda.synchronize()
    assert flash_attention_p5_bwd.launches == before + 2
    designs[flash_p5_bwd_design(dtype, d, d ** -0.5)] += 2
    assert flash_attention_p5_bwd.launches_by_design == designs
    assert torch.equal(got, again)
    want = flash_attention_p5_bwd_reference(f5, out, lse, g)
    assert got.dtype == dtype and got.shape == f5.shape
    for i, name in enumerate(("dq", "dk", "dv")):
        w = want[:, i].float()
        err = (got[:, i].float() - w).abs().max().item()
        assert err <= rtol * w.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,scale", [(4, 256, 9, 64, -0.2), (2, 136, 2, 32, 0.0),
                                           (2, 256, 4, 128, 128 ** -0.5)])
def test_cuda_backward_mma_sync_takes_what_wgmma_does_not(b, t, h, d, scale):
    """A scale <= 0 runs the mma.sync backward, counted there; D = 128, which
    the wgmma pair takes since it gives dV and dK a warpgroup each, runs
    that pair."""
    _cuda()
    f5, g = (torch.from_numpy(a).cuda().to(torch.bfloat16)
             for a in _inputs(b, t, h, d, seed=10))
    out, lse = flash_attention_p5_fwd(f5, scale)
    design = flash_p5_bwd_design(torch.bfloat16, d, scale)
    assert design == ("wgmma" if scale > 0 else "mma_sync")
    before = flash_attention_p5_bwd.launches_by_design[design]
    got = flash_attention_p5_bwd(f5, out, lse, g, scale)
    torch.cuda.synchronize()
    assert flash_attention_p5_bwd.launches_by_design[design] == before + 1
    want = flash_attention_p5_bwd_reference(f5, out, lse, g, scale)
    for i, name in enumerate(("dq", "dk", "dv")):
        w = want[:, i].float()
        err = (got[:, i].float() - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_packed_entry_takes_the_p5_kernels():
    _cuda()
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy((rng.standard_normal((4, 256, 3, 16, 32)) * 0.5)
                           .astype(np.float32)).cuda().to(torch.bfloat16)
    qkv.requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((4, 256, 16, 32)).astype(np.float32)).cuda()
    counts = (flash_attention_p5.launches, flash_attention_p5_bwd.launches)
    out = flash_attention_packed(qkv)
    (out.float() * g).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_p5.launches, flash_attention_p5_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    want = flash_attention_reference(*qkv.detach().unbind(2))[0]
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    assert qkv.grad.shape == qkv.shape and qkv.grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    _cuda()
    with pytest.raises(ValueError, match="D <= 128"):
        flash_attention_p5_fwd(torch.zeros(1, 3, 1, 136, 256, device="cuda"))
    with pytest.raises(ValueError, match="T % 8"):
        flash_attention_p5_fwd(torch.zeros(1, 3, 1, 8, 250, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_p5_fwd(torch.zeros(1, 3, 1, 256, 8, device="cuda").transpose(3, 4))
    half = torch.zeros(1, 3, 1, 8, 256, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_p5_fwd(half)
