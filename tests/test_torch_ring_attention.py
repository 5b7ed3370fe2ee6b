"""The port's ring attention (vaw_torch/parallel/ring_attention.py) on
S = 2 and 4 gloo CPU ranks against JAX's ring_attention on the virtual
mesh, from the same numpy q, k and v [B, T, H, D] (each torch rank given
its token rows): the output and the gradients of sum(out * g).

Tolerances: f32 outputs within 1e-5 and gradients within 1e-5 of max|g|
plus 1e-6 (both accumulate in f32 with the same online softmax, in
different summation orders); bf16 inputs at S = 2 within the bound of
tests/test_ring_attention.py:67 (0.05 absolute and relative) of JAX's
bf16 ring."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_ranks import run_ranks
from vaw_tpu.parallel.ring_attention import ring_attention


def _inputs(seed=0, b=2, t=32, h=4, d=16):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, g, n, dtype=jnp.float32):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))

    def loss(q, k, v):
        out = ring_attention(q, k, v, mesh)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def _torch(q, k, v, g, n, tmp_path, dtype="float32"):
    parts = run_ranks("_torch_parallel_workers:ring", n, tmp_path, q, k, v, g, dtype)
    return [np.concatenate([p[i] for p in parts], axis=1) for i in range(4)]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_f32(n, tmp_path):
    q, k, v, g = _inputs(seed=n)
    want = _jax(q, k, v, g, n)
    got = _torch(q, k, v, g, n, tmp_path)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max() + 1e-6,
                                   err_msg=name)


def test_ring_matches_jax_bf16_two_ranks(tmp_path):
    q, k, v, g = _inputs(seed=7)
    want = _jax(q, k, v, g, 2, jnp.bfloat16)
    got = _torch(q, k, v, g, 2, tmp_path, "bfloat16")
    np.testing.assert_allclose(got[0], want[0], rtol=0.05, atol=0.05)
