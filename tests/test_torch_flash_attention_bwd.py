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
  rounded once to bf16).

JAX is imported inside the tests that compare with it, so the CUDA cases
also collect on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vaw_torch.ops.flash_attention import (
    flash_attention_fused,
    flash_attention_fused_bwd,
    flash_attention_fused_bwd_reference,
    flash_attention_fused_reference,
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 12, 64), (2, 257, 12, 64),
                                     (2, 77, 3, 8), (2, 300, 2, 128),
                                     (2, 100, 2, 24)])
def test_cuda_bwd_kernel_matches_reference(b, t, h, d, dtype, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    f, g = _inputs(b, t, h, d, seed=5)
    x = torch.from_numpy(f).cuda().to(dtype)
    dout = torch.from_numpy(g).cuda().to(dtype)
    out, lse = flash_attention_fused(x, h)
    before = flash_attention_fused_bwd.launches
    got = flash_attention_fused_bwd(x, out, lse, dout, h)
    torch.cuda.synchronize()
    assert flash_attention_fused_bwd.launches == before + 1
    want = flash_attention_fused_bwd_reference(x, out, lse, dout, h)
    assert got.dtype == dtype and got.shape == x.shape
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * scale, (err, scale)


@pytest.mark.cuda
def test_cuda_autograd_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    f, g = _inputs(2, 256, 4, 64, seed=6)
    x = torch.from_numpy(f).cuda().to(torch.bfloat16).requires_grad_(True)
    before = (flash_attention_fused.launches, flash_attention_fused_bwd.launches)
    out, _ = flash_attention_fused(x, 4)
    (out.float() * torch.from_numpy(g).cuda()).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_fused.launches,
            flash_attention_fused_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
