"""Parity of the port's fused-attention backward (vaw_torch/ops/
flash_attention.py) with the JAX package's _flash_p6 custom_vjp, whose
Pallas backward kernel (_bwd_kernel_p6) runs in interpret mode on the CPU.
Inputs and the incoming gradient come from numpy with a fixed seed.

Tolerances:
- port CPU autograd against jax.grad through the Pallas kernels: atol and
  rtol 5e-4, the bound tests/test_ops.py:331-332 holds the Pallas backward
  to (f32 on both sides, different summation order);
- flash_attention_fused_bwd_reference against autograd of the plain
  forward: atol 1e-5 (the same f32 math, P from lse instead of softmax);
- the CUDA kernel against flash_attention_fused_bwd_reference on the card:
  f32 within 1e-4 of max|dqkv|, bf16 within 2e-2 of max|dqkv| (P and dS
  enter the tensor-core products as bf16 hi + lo, about 16 bits; dqkv is
  rounded once to bf16); a repeated call is bit-equal (no atomics).

The kernels are chosen by the call (``flash_fused_bwd_design``): with
D <= 64 and scale > 0 the general backward's pair on the packed row's
views, TMA + wgmma in bf16 and its 3xTF32 design in f32 (at or above
``TF32X3_MIN_TILES`` score tiles), other calls the mma.sync kernels in bf16
and the FMA ones in f32; the CPU tests check that choice and that every
bf16 DiT-B/2 call takes wgmma.

JAX is imported inside the tests that compare with it, so the CUDA cases
also collect on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vaw_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_fused,
    flash_attention_fused_bwd,
    flash_attention_fused_bwd_reference,
    flash_attention_fused_reference,
    flash_fused_bwd_design,
)


def _inputs(b, t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32)
    g = rng.standard_normal((b, t, h * d)).astype(np.float32)
    return f, g


@pytest.mark.parametrize("b,t,h,d", [(4, 256, 12, 64), (2, 256, 2, 64)])
def test_cpu_autograd_matches_pallas_bwd_interpret(b, t, h, d):
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    f, g = _inputs(b, t, h, d)
    assert jax_flash.flash_fused_supported(b, h, d, t)
    want = jax.grad(lambda x: jnp.sum(jax_flash.flash_attention_fused(x, h) * g))(
        jnp.asarray(f))
    x = torch.from_numpy(f).requires_grad_(True)
    out, _ = flash_attention_fused(x, h)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("b,t,h,d", [(2, 77, 3, 8), (1, 130, 2, 128),
                                     (2, 257, 2, 24)])
def test_bwd_reference_matches_autograd_of_plain_forward(b, t, h, d):
    f, g = _inputs(b, t, h, d, seed=1)
    x = torch.from_numpy(f).requires_grad_(True)
    out, lse = flash_attention_fused_reference(x, h)  # plain autograd graph
    (out * torch.from_numpy(g)).sum().backward()
    got = flash_attention_fused_bwd_reference(
        x.detach(), out.detach(), lse.detach(), torch.from_numpy(g), h)
    assert got.shape == (b, t, 3 * h * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), atol=1e-5, rtol=0)


def test_bwd_reference_scale_placement():
    """dq carries the scale after dS k and dk uses the scaled q: with a
    non-default scale both differ from the default-scale gradient in the
    way autograd of the plain forward says."""
    f, g = _inputs(1, 40, 2, 16, seed=2)
    for scale in (0.37, 1.0 / np.sqrt(16)):
        x = torch.from_numpy(f).requires_grad_(True)
        out, lse = flash_attention_fused_reference(x, 2, scale)
        (out * torch.from_numpy(g)).sum().backward()
        got = flash_attention_fused_bwd_reference(
            x.detach(), out.detach(), lse.detach(), torch.from_numpy(g), 2, scale)
        np.testing.assert_allclose(got.numpy(), x.grad.numpy(), atol=1e-5, rtol=0)


def test_cpu_backward_launches_no_kernel():
    before = (flash_attention_fused.launches, flash_attention_fused_bwd.launches)
    f, g = _inputs(1, 64, 2, 32, seed=3)
    x = torch.from_numpy(f).requires_grad_(True)
    out, _ = flash_attention_fused(x, 2)
    (out * torch.from_numpy(g)).sum().backward()
    assert x.grad.shape == x.shape
    assert (flash_attention_fused.launches,
            flash_attention_fused_bwd.launches) == before


def test_bwd_wrapper_rejects_malformed_input():
    f, g = _inputs(2, 16, 2, 8, seed=4)
    x = torch.from_numpy(f)
    out, lse = flash_attention_fused_reference(x, 2)
    with pytest.raises(ValueError):
        flash_attention_fused_bwd(x, out, lse, torch.from_numpy(g), 5)


@pytest.mark.parametrize("dtype,d,scale,design", [
    (torch.bfloat16, 64, 0.125, "wgmma"), (torch.bfloat16, 32, 32 ** -0.5, "wgmma"),
    (torch.bfloat16, 8, 0.3, "wgmma"), (torch.bfloat16, 72, 72 ** -0.5, "mma_sync"),
    (torch.bfloat16, 128, 0.3, "mma_sync"), (torch.bfloat16, 64, -0.3, "mma_sync"),
    (torch.bfloat16, 64, 0.0, "mma_sync"), (torch.float32, 64, 0.125, "tf32x3"),
    (torch.float32, 128, -0.3, "fma")])
def test_backward_design_is_chosen_by_the_call(dtype, d, scale, design):
    """bf16 takes the TMA + wgmma pair for D <= 64 with a positive scale
    (flash_bwd_design's limits), mma.sync otherwise (DiT-XL/2's D = 72, D =
    128, a scale <= 0); f32 under the same limits the pair's 3xTF32 design
    (a call ruled on D and scale alone: the score tiles are the views'), the
    FMA kernels otherwise."""
    assert flash_fused_bwd_design(dtype, d, scale) == design


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_backward_counts_no_launch_by_design(dtype):
    before = (dict(flash_attention_fused_bwd.launches_by_design),
              dict(flash_attention_bwd.launches_by_design))
    f, g = _inputs(1, 64, 2, 32, seed=7)
    x = torch.from_numpy(f).to(dtype).requires_grad_(True)
    out, _ = flash_attention_fused(x, 2)
    (out * torch.from_numpy(g).to(dtype)).sum().backward()
    assert x.grad.shape == x.shape
    assert (flash_attention_fused_bwd.launches_by_design,
            flash_attention_bwd.launches_by_design) == before


def test_dit_b2_calls_take_the_wgmma_backward():
    """Every fused attention call of one bf16 DiT-B/2 forward (twelve blocks,
    12 heads of 64 at T = 256), recorded on the meta device, goes to the
    TMA + wgmma backward."""
    from vaw_torch.models.dit import DiT_B
    from vaw_torch.ops import attention as port_attention

    calls = []

    def record(qkv2d, num_heads, scale=None):
        calls.append((tuple(qkv2d.shape), qkv2d.dtype, num_heads, scale))
        return qkv2d[..., :qkv2d.shape[-1] // 3], None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "flash_attention_fused", record)
        with torch.device("meta"):
            model = DiT_B(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                          class_dropout_prob=0.1, learn_sigma=False,
                          compute_dtype=torch.bfloat16).to("meta")  # pos_embed too
            model(torch.empty(2, 32, 32, 4), torch.empty(2), torch.zeros(2, dtype=torch.long))
    assert [c[:3] for c in calls] == [((2, 256, 3 * 12 * 64), torch.bfloat16, 12)] * 12
    for shape, dtype, h, scale in calls:
        d = shape[-1] // (3 * h)
        assert scale is None
        assert flash_fused_bwd_design(dtype, d, 1.0 / np.sqrt(d)) == "wgmma"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 12, 64), (2, 257, 12, 64),
                                     (2, 77, 3, 8), (2, 300, 2, 128),
                                     (2, 100, 2, 24)])
def test_cuda_bwd_kernel_matches_reference(b, t, h, d, dtype, rtol):
    """Each shape through the kernels its call selects (counted by kernel,
    none under the general backward's counters), bit-equal when repeated."""
    _cuda()
    f, g = _inputs(b, t, h, d, seed=5)
    x = torch.from_numpy(f).cuda().to(dtype)
    dout = torch.from_numpy(g).cuda().to(dtype)
    out, lse = flash_attention_fused(x, h)
    before = flash_attention_fused_bwd.launches
    designs = dict(flash_attention_fused_bwd.launches_by_design)
    general = dict(flash_attention_bwd.launches_by_design)
    got = flash_attention_fused_bwd(x, out, lse, dout, h)
    again = flash_attention_fused_bwd(x, out, lse, dout, h)
    torch.cuda.synchronize()
    assert flash_attention_fused_bwd.launches == before + 2
    views = x.view(b, t, 3, h, d).unbind(2)
    designs[flash_fused_bwd_design(dtype, d, d ** -0.5, views * 2)] += 2
    assert flash_attention_fused_bwd.launches_by_design == designs
    assert flash_attention_bwd.launches_by_design == general
    assert torch.equal(got, again)
    want = flash_attention_fused_bwd_reference(x, out, lse, dout, h)
    assert got.dtype == dtype and got.shape == x.shape
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,scale", [(2, 256, 4, 64, -0.2), (2, 257, 3, 32, 0.0)])
def test_cuda_bwd_with_a_scale_not_above_zero_takes_mma_sync(b, t, h, d, scale):
    _cuda()
    f, g = _inputs(b, t, h, d, seed=8)
    x = torch.from_numpy(f).cuda().to(torch.bfloat16)
    dout = torch.from_numpy(g).cuda().to(torch.bfloat16)
    out, lse = flash_attention_fused(x, h, scale)
    before = flash_attention_fused_bwd.launches_by_design["mma_sync"]
    got = flash_attention_fused_bwd(x, out, lse, dout, h, scale)
    torch.cuda.synchronize()
    assert flash_attention_fused_bwd.launches_by_design["mma_sync"] == before + 1
    want = flash_attention_fused_bwd_reference(x, out, lse, dout, h, scale)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_autograd_launches_both_kernels():
    _cuda()
    f, g = _inputs(2, 256, 4, 64, seed=6)
    x = torch.from_numpy(f).cuda().to(torch.bfloat16).requires_grad_(True)
    before = (flash_attention_fused.launches, flash_attention_fused_bwd.launches)
    out, _ = flash_attention_fused(x, 4)
    (out.float() * torch.from_numpy(g).cuda()).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_fused.launches,
            flash_attention_fused_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
