"""Parity of the port's fused bias + leaky ReLU (vaw_torch/ops/fused_act.py)
with the JAX package's (vaw_tpu/ops/fused_act.py, whose Pallas kernel runs
in interpret mode on the CPU by itself), on numpy inputs from a seed.

Tolerances: f32 values within 1e-6 relative (the same three operations in
the same order); bf16 values equal (both round after the add, the slope
multiply and the scale multiply, with the constants rounded to bf16).
Gradients: f32 within 1e-6 relative; bf16 within 1e-2 of the largest
magnitude (the bias gradient is a bf16 sum over 96 rows, accumulated in
another order). Second derivatives: 1e-5 relative, as tests/test_ops.py.

Tests marked ``cuda`` hold the kernel against its plain version on the card
and skip here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.ops import fused_act as port_act
from vaw_tpu.ops import fused_act as jax_act

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape=(2, 4, 4, 6), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = (0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, b, g


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("slope,scale", [(0.2, 2 ** 0.5), (0.1, 2.0)])
def test_values_match_jax(dtype, slope, scale):
    jdt, tdt = DTYPES[dtype]
    x, b, _ = _inputs()
    want = _f32(jax_act.fused_leaky_relu(jnp.asarray(x, jdt), jnp.asarray(b, jdt),
                                         slope, scale))
    got = port_act.fused_leaky_relu(torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(b).to(tdt), slope, scale)
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == "bf16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_module_casts_its_bias_to_the_input_dtype():
    """The module's f32 bias on a bf16 input is rounded to bf16 first, as a
    bf16 Flax parameter tree would hold it: equal to JAX in bf16."""
    x, b, _ = _inputs(seed=1)
    module = port_act.FusedLeakyReLU(6)
    with torch.no_grad():
        module.bias.copy_(torch.from_numpy(b))
    got = module(torch.from_numpy(x).bfloat16())
    want = _f32(jax_act.fused_leaky_relu(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(b, jnp.bfloat16)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    got.float().sum().backward()
    assert module.bias.grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grads_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x, b, g = _inputs((3, 4, 8, 8), seed=2)
    jg = jnp.asarray(g, jdt)
    dx, db = jax.grad(lambda a, c: jnp.sum((jax_act.fused_leaky_relu(a, c) * jg).astype(
        jnp.float32)), argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(b, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tb = torch.from_numpy(b).to(tdt).requires_grad_(True)
    (port_act.fused_leaky_relu(tx, tb) * torch.from_numpy(g).to(tdt)).float().sum().backward()
    for got, want in ((tx.grad, dx), (tb.grad, db)):
        assert got.dtype == tdt
        want = _f32(want)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= (1e-6 if dtype == "f32" else 1e-2), err


def test_second_derivative_matches_jax():
    """jax.grad of jax.grad against torch's double backward (the reference
    CUDA op's grad=2 path, tests/test_ops.py:96-113)."""
    x = np.array([[-1.5, 0.5, 2.0, -0.1]], np.float32)
    b = np.array([0.3, -0.2, 0.0, 0.05], np.float32)
    jb = jnp.asarray(b)

    def f(a):
        return jnp.sum(jax_act.fused_leaky_relu(a, jb, 0.2, 2.0) ** 2)

    want_g = np.asarray(jax.grad(f)(jnp.asarray(x)))
    want_h = np.asarray(jax.grad(lambda a: jnp.sum(jax.grad(f)(a)))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = port_act.fused_leaky_relu(tx, torch.from_numpy(b), 0.2, 2.0)
    (gx,) = torch.autograd.grad((out ** 2).sum(), tx, create_graph=True)
    (h,) = torch.autograd.grad(gx.sum(), tx)
    np.testing.assert_allclose(gx.detach().numpy(), want_g, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5)
    y = x + b
    np.testing.assert_allclose(h.numpy(), 2 * (2.0 * np.where(y >= 0, 1.0, 0.2)) ** 2,
                               rtol=1e-5)


def test_module_matches_jax_shim():
    x, b, _ = _inputs((2, 3, 5), seed=3)
    module = port_act.FusedLeakyReLU(5, negative_slope=0.1, scale=1.5)
    assert module.bias.dtype == torch.float32 and not module.bias.any()
    with torch.no_grad():
        module.bias.copy_(torch.from_numpy(b))
    want = np.asarray(jax_act.FusedLeakyReLU(0.1, 1.5)(jnp.asarray(x), jnp.asarray(b)))
    got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=0)
    got.sum().backward()
    assert module.bias.grad.shape == (5,)


def test_refuses_a_bias_off_the_last_axis_or_in_another_dtype():
    with pytest.raises(ValueError, match="last axis"):
        port_act.fused_leaky_relu(torch.zeros(2, 3, 4), torch.zeros(3))
    with pytest.raises(TypeError, match="x's dtype"):
        port_act.fused_leaky_relu(torch.zeros(2, 3, 4, dtype=torch.bfloat16),
                                  torch.zeros(4))


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


# ADM-64's width, channels that leave a scalar tail or split 16-byte chunks
# across rows, and one row.
CUDA_SHAPES = [(4, 64, 64, 192), (3, 5, 7, 3), (2, 9, 13), (1, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernel_matches_reference(shape, dtype):
    _cuda()
    x, b, _ = _inputs(shape, seed=4)
    tx = torch.from_numpy(x).cuda().to(dtype)
    tb = torch.from_numpy(b).cuda().to(dtype)
    before = port_act.fused_leaky_relu.launches
    got = port_act.fused_leaky_relu(tx, tb)
    torch.cuda.synchronize()
    assert port_act.fused_leaky_relu.launches == before + 1
    want = port_act.fused_leaky_relu_reference(tx, tb)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_grads_through_the_kernel():
    _cuda()
    x, b, g = (torch.from_numpy(a).cuda() for a in _inputs((2, 8, 8, 16), seed=5))
    x.requires_grad_(True)
    b.requires_grad_(True)
    before = port_act.fused_leaky_relu.launches
    out = port_act.fused_leaky_relu(x, b)
    gx, gb = torch.autograd.grad((out * g).sum(), (x, b))
    (hx,) = torch.autograd.grad(
        torch.autograd.grad((port_act.fused_leaky_relu(x, b) ** 2).sum(), x,
                            create_graph=True)[0].sum(), x)
    assert port_act.fused_leaky_relu.launches == before + 2
    mult = torch.where((x + b).detach() >= 0, 2 ** 0.5, 0.2 * 2 ** 0.5)
    torch.testing.assert_close(gx, g * mult)
    torch.testing.assert_close(gb, (g * mult).sum((0, 1, 2)))
    torch.testing.assert_close(hx, 2 * mult ** 2)
