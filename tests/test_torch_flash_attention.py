"""Parity of the port's fused attention (vaw_torch/ops/flash_attention.py)
with the JAX package's _flash_p6, whose Pallas kernel runs in interpret mode
on the CPU. Inputs come from numpy with a fixed seed and go to both sides.

Tolerances: f32 output atol/rtol 5e-5 and lse atol 1e-5 (f32 math on both
sides, different summation order); bf16 output 1 bf16 ulp of |o| <= 1
(2**-7) against the f32 math on the same bf16 inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.ops.attention import self_attention_qkv2d
from vaw_torch.ops.flash_attention import (
    flash_attention_fused,
    flash_attention_fused_reference,
)
from vaw_tpu.ops import flash_attention as jax_flash


def _qkv(b, t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32)


def _jax_softmax_attention(f, h):
    """Plain JAX softmax attention on the fused layout, f32."""
    b, t, hd3 = f.shape
    d = hd3 // 3 // h
    qkv = jnp.asarray(f).reshape(b, t, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    s = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(d)
    lse = jax.scipy.special.logsumexp(s, axis=-1)
    o = jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(s, axis=-1), v)
    return np.asarray(o.reshape(b, t, h * d)), np.asarray(lse.reshape(b * h, t))


@pytest.mark.parametrize("b,t,h,d", [(4, 256, 12, 64), (2, 256, 2, 64)])
def test_reference_matches_pallas_p6_interpret(b, t, h, d):
    f = _qkv(b, t, h, d)
    assert jax_flash.flash_fused_supported(b, h, d, t)
    scale = 1.0 / np.sqrt(d)
    want_o = np.asarray(jax_flash.flash_attention_fused(jnp.asarray(f), h))
    _, (_, _, want_lse) = jax_flash._flash_p6_fwd(jnp.asarray(f), h, scale)
    got_o, got_lse = flash_attention_fused(torch.from_numpy(f), h)
    assert got_o.shape == (b, t, h * d) and got_o.dtype == torch.float32
    assert got_lse.shape == (b * h, t) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5)


@pytest.mark.parametrize("b,t,h,d", [(2, 257, 2, 64), (3, 77, 3, 8),
                                     (1, 300, 1, 128)])
def test_reference_ragged_t_matches_jax_math(b, t, h, d):
    f = _qkv(b, t, h, d, seed=1)
    want_o, want_lse = _jax_softmax_attention(f, h)
    got_o, got_lse = flash_attention_fused_reference(torch.from_numpy(f), h)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5)


def test_reference_bf16_io_keeps_f32_math():
    f = _qkv(2, 256, 2, 64, seed=2)
    fb = torch.from_numpy(f).to(torch.bfloat16)
    o, lse = flash_attention_fused(fb, 2)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want_o, want_lse = _jax_softmax_attention(fb.float().numpy(), 2)
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=2 ** -7, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)


def test_cpu_call_launches_no_kernel():
    before = flash_attention_fused.launches
    f = torch.from_numpy(_qkv(1, 64, 2, 32, seed=3))
    out = self_attention_qkv2d(f, 2)
    flash_attention_fused(f, 2)
    assert out.shape == (1, 64, 64)
    assert flash_attention_fused.launches == before


@pytest.mark.parametrize("bad", ["heads", "rank"])
def test_wrapper_rejects_malformed_input(bad):
    f = torch.zeros(2, 16, 3 * 2 * 8)
    with pytest.raises(ValueError):
        if bad == "heads":
            flash_attention_fused(f, 5)
        else:
            flash_attention_fused(f[0], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 12, 64), (2, 257, 12, 64),
                                     (2, 77, 3, 8), (2, 300, 2, 128), (3, 64, 4, 40),
                                     (2, 1024, 2, 72), (1, 129, 5, 120)])
def test_cuda_kernel_matches_reference(b, t, h, d, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    f = torch.from_numpy(_qkv(b, t, h, d, seed=4)).cuda().to(dtype)
    before = flash_attention_fused.launches
    o, lse = flash_attention_fused(f, h)
    torch.cuda.synchronize()
    assert flash_attention_fused.launches == before + 1
    ro, rlse = flash_attention_fused_reference(f, h)
    assert o.dtype == dtype and o.shape == (b, t, h * d)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-1.0, 0.0])
def test_cuda_bf16_forward_takes_a_scale_not_above_zero(scale):
    """The bf16 TMA + wgmma kernel takes its softmax's max on the raw
    scores, which holds for scale > 0 only: at scale -1 with scores spread
    over hundreds its exponentials overflowed. Such a call runs the general
    mma.sync forward on the packed row's views instead, within one bf16
    rounding of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    f = (torch.from_numpy(_qkv(2, 256, 4, 64, seed=9)) * 8).cuda().to(torch.bfloat16)
    before = flash_attention_fused.launches
    o, lse = flash_attention_fused(f, 4, scale)
    torch.cuda.synchronize()
    assert flash_attention_fused.launches == before + 1
    ro, rlse = flash_attention_fused_reference(f, 4, scale)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    atol = 2 ** -7 * ro.float().abs().max().item()
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4 * rlse.abs().max().item(), rtol=0)
