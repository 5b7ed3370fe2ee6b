"""The port's upfirdn2d (vaw_torch/ops/upfirdn2d.py) against the JAX
package's (vaw_tpu/ops/upfirdn2d.py) on the same seeded inputs: values on
the (up, down, pad) grid of tests/test_ops.py, tuple up/down, 4-tuple and
negative pads, with StyleGAN2's symmetric kernel and a seeded asymmetric
one (which a missing flip would not survive); upsample2d, downsample2d,
blur; first and second derivatives; no_weight_gradients; make_kernel.

Tolerances: both sides are one f32 depthwise conv of the same products in
another order: values within 1e-5 (absolute and relative), derivatives
within 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.ops import upfirdn2d as port
from vaw_tpu.ops import upfirdn2d as ref

GRID = [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (3, 2)), (1, 1, (-1, 2)),
        ((2, 1), (1, 2), (1, 2, 0, 3)), ((1, 3), 2, (2, 1)), (2, (2, 1), (0, 1, 2, 2)),
        (2, 1, (-2, 1, 1, -1)), (1, 2, (-1, -1, 2, 0)), (4, 2, (3, -2))]


def _kernel(name):
    if name == "sym":
        return ref.make_kernel([1, 3, 3, 1])
    return np.random.RandomState(7).rand(3, 4).astype(np.float32)


def _x(shape=(2, 7, 6, 3), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kernel", ["sym", "asym"])
@pytest.mark.parametrize("up,down,pad", GRID)
def test_upfirdn2d_matches_jax(up, down, pad, kernel):
    x, k = _x(), _kernel(kernel)
    want = np.asarray(ref.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad))
    got = port.upfirdn2d(torch.from_numpy(x), k, up=up, down=down, pad=pad)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fn,kwargs", [
    ("upsample2d", {}), ("upsample2d", {"factor": 4, "gain": 2}),
    ("upsample2d", {"kernel": (1, 2, 1)}), ("downsample2d", {}),
    ("downsample2d", {"kernel": (1, 3, 3, 1), "factor": 4}), ("blur", {}),
    ("blur", {"kernel": (1, 2, 1), "pad": (1, 1)})])
def test_resamplers_match_jax(fn, kwargs):
    x = _x((2, 8, 8, 4), seed=1)
    want = np.asarray(getattr(ref, fn)(jnp.asarray(x), **kwargs))
    got = getattr(port, fn)(torch.from_numpy(x), **kwargs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("up,down,pad", [(2, 2, (1, 1)), ((2, 1), 1, (2, 1, 1, 2)),
                                         (1, 2, (-1, 2))])
def test_first_and_second_derivatives_match_jax(up, down, pad):
    x, k = _x((1, 6, 6, 2), seed=2), _kernel("asym")
    out_shape = ref.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad).shape
    c = np.random.RandomState(3).randn(*out_shape).astype(np.float32)

    def f_jax(x):
        return jnp.sum(ref.upfirdn2d(x, k, up=up, down=down, pad=pad) ** 2 * c)

    g_want = np.asarray(jax.grad(f_jax)(jnp.asarray(x)))
    h_want = np.asarray(jax.grad(lambda x: jnp.sum(jax.grad(f_jax)(x) ** 2))(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_()
    loss = (port.upfirdn2d(xt, k, up=up, down=down, pad=pad) ** 2 * torch.from_numpy(c)).sum()
    (g,) = torch.autograd.grad(loss, xt, create_graph=True)
    (h,) = torch.autograd.grad((g ** 2).sum(), xt)
    np.testing.assert_allclose(g.detach().numpy(), g_want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_want, atol=1e-4, rtol=1e-4)
    assert np.abs(h_want).max() > 1e-2


def test_no_weight_gradients_leaves_no_weight_gradient():
    x = torch.from_numpy(_x((1, 6, 6, 2), seed=4)).requires_grad_()
    w = torch.from_numpy(_kernel("asym")).requires_grad_()

    def conv(x, w):
        return port.upfirdn2d(x, w, up=2, pad=(2, 1))

    (conv(x, w) ** 2).sum().backward()
    dx, dw = x.grad.clone(), w.grad
    assert dw is not None and dw.abs().max() > 0
    x.grad, w.grad = None, None
    (port.no_weight_gradients(conv)(x, w) ** 2).sum().backward()
    assert w.grad is None
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)

    def conv_jax(x, w):
        return ref.upfirdn2d(x, w, up=2, pad=(2, 1))

    dw_jax = jax.grad(lambda w: jnp.sum(ref.no_weight_gradients(conv_jax)(
        jnp.asarray(x.detach().numpy()), w) ** 2))(jnp.asarray(w.detach().numpy()))
    assert not np.asarray(dw_jax).any()


@pytest.mark.parametrize("k", [[1, 3, 3, 1], [1, 2, 1], [[1, 2], [3, 4]], [1.5, 0.25, 2]])
def test_make_kernel_is_bit_equal(k):
    got, want = port.make_kernel(k), ref.make_kernel(k)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
