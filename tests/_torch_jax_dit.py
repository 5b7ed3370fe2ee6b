"""A tiny JAX DiT with every leaf randomised from a numpy seed (the
adaLN-Zero modulation and head included, so every gradient is nonzero),
its weights converted for the port's DiT, and the JAX gradient of
sum(out * g) under the port's names: the JAX side of the parallel parity
tests."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from vaw_torch.models.convert import flax_dit_to_torch
from vaw_tpu.models.dit import DiT as JaxDiT


def randomize(params, seed):
    """Seeded normal noise in every leaf: kernels ~ 1/sqrt(fan_in) (a
    stacked block's leading depth axis aside), tables 0.3, the rest 0.05."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        stacked = "ScanBlocks" in jax.tree_util.keystr(path)
        fan_in = np.prod(p.shape[1 if stacked else 0:-1])
        std = (1.0 / np.sqrt(fan_in) if name == "kernel"
               else 0.3 if name == "embedding" else 0.05)
        return jnp.asarray(rng.standard_normal(p.shape) * std, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def tiny(image_size, depth, scan_blocks=False, seed=1):
    """(JAX model, randomised params, the port's DiT kwargs, the port's
    state dict as numpy)."""
    spec = dict(image_size=image_size, patch_size=2, in_channels=4, hidden_size=32,
                depth=depth, num_heads=2, num_classes=10, class_dropout_prob=0.0)
    model = JaxDiT(**spec, scan_blocks=scan_blocks)
    x = jnp.zeros((1, image_size, image_size, 4))
    params = model.init(jax.random.key(0), x, jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    params = randomize(params["params"], seed)
    sd = {k: v.numpy() for k, v in flax_dit_to_torch(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return model, params, spec, sd


def inputs(batch, image_size, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, image_size, image_size, 4).astype(np.float32)
    t = (rs.rand(batch) * 10).astype(np.float32)
    y = (np.arange(batch) % 10).astype(np.int32)
    g = rs.randn(batch, image_size, image_size, 4).astype(np.float32)
    return x, t, y, g


def value_and_grads(apply_fn, params, x, t, y, g):
    """(out, {port name: grad}) of sum(apply_fn(...) * g), jitted."""
    def loss(p):
        out, _ = apply_fn({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads = {k: v.numpy() for k, v in flax_dit_to_torch(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    return np.asarray(out), grads
