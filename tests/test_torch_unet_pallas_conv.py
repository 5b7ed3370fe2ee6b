"""The port's ADM UNet under VAW_PALLAS_CONV=1 against the JAX package's,
on the same weights and inputs: the tree a flagged JAX init makes crosses
through flax_unet_to_torch onto the flagged port model, and the two agree
in the forward and in the gradient.

The small UNet is pixel-space, as ADM-64 is: 16x16x3 images, 16 model
channels, channel_mult (1, 2), one res block a level, attention at 8x8 with
heads of 8, 10 classes with the null row. Every stride-1 3x3 conv passes
the gate at 16 and 8 pixels, so each one runs ``conv3x3``: on the CPU the
port's plain versions, in JAX the Pallas kernels in interpret mode
(``pl.pallas_call`` patched with ``interpret=True``, as tests/test_ops.py
does; nothing in vaw_tpu changes). One module-scoped fixture makes the
weights, the inputs and both packages' results once.

Tolerances: the f32 forward within 1e-4 of max|out| (f32 on both sides,
JAX at "highest" precision, another summation order); each parameter's f32
gradient within 1e-4 of the largest gradient magnitude of its tensor plus
1e-6 of the largest over the model (the conv biases in front of a GroupNorm
get only rounding noise, which a bound relative to the tensor alone would
divide by itself); the port's bf16 compute against the f32 JAX forward
within 3e-2 of max|out|, as tests/test_torch_unet.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vaw_tpu.ops.conv2d as jax_conv
from vaw_torch.models import unet as port_unet
from vaw_torch.models.convert import flax_unet_to_torch
from vaw_tpu.models.unet import UNetModel as JaxUNet

SMALL = dict(image_size=16, in_channels=3, model_channels=16, out_channels=3,
             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
             num_head_channels=8, num_classes=10, drop_label_prob=0.1)
# The stem, two convs in each of the ten ResBlocks (three in the encoder,
# the down-sampling one among them, two in the middle, five in the decoder)
# but the up-sampling one's first (a nearest-2x + conv), and the head.
N_ROUTED = 1 + 2 * 10 - 1 + 1


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf: kernels ~ 1/sqrt(fan_in),
    GroupNorm scales ~ 1 + 0.1 N, the label table ~ 0.3, biases ~ 0.05."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        return (z * (0.3 if name == "embedding" else 0.05)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _inputs(n=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(0, 999, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    g = rng.standard_normal((n, 16, 16, 3)).astype(np.float32)
    return x, t, y, g


@pytest.fixture(scope="module")
def flagged():
    x, t, y, g = _inputs()
    gates = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VAW_PALLAS_CONV", "1")
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        real = jax_conv.conv3x3_supported
        mp.setattr(jax_conv, "conv3x3_supported", lambda *a, **k: gates["jax"].append(
            real(*a, **k)) or gates["jax"][-1])
        jmodel = JaxUNet(**SMALL)
        params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                                      jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
        params = _randomize(params, seed=11)
        gates["jax"].clear()

        def loss(p, xs):
            out = jmodel.apply({"params": p}, xs, jnp.asarray(t), jnp.asarray(y))
            return jnp.sum(out * jnp.asarray(g)), out

        (_, want), (want_grads, want_dx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tmodel = port_unet.UNetModel(**SMALL)
        tmodel.load_state_dict(flax_unet_to_torch(params, tmodel), strict=True)
        real_port = port_unet.conv3x3_supported
        mp.setattr(port_unet, "conv3x3_supported", lambda *a, **k: gates["port"].append(
            real_port(*a, **k)) or gates["port"][-1])
        tx = torch.from_numpy(x).requires_grad_(True)
        got = tmodel(tx, torch.from_numpy(t), torch.from_numpy(y).long())
        (got * torch.from_numpy(g)).sum().backward()
    return dict(params=params, tmodel=tmodel, want=np.asarray(want), got=got.detach().numpy(),
                want_grads=flax_unet_to_torch(jax.device_get(want_grads), tmodel),
                want_dx=np.asarray(want_dx), got_dx=tx.grad.numpy(), gates=gates,
                inputs=(x, t, y))


def test_flagged_tree_loads_into_the_flagged_port_model(flagged):
    tmodel = flagged["tmodel"]
    routed = [m for m in tmodel.modules() if isinstance(m, port_unet.PallasConv3x3)]
    assert len(routed) == N_ROUTED
    assert tmodel.out[2] in routed and tmodel.input_blocks[0][0] in routed
    sd = tmodel.state_dict()
    for name, value in flax_unet_to_torch(flagged["params"], tmodel).items():
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(value), err_msg=name)


def test_flagged_convs_take_the_kernel_in_both(flagged):
    gates = flagged["gates"]
    assert gates["port"] == gates["jax"] == [True] * N_ROUTED


def test_flagged_forward_matches_jax(flagged):
    want, got = flagged["want"], flagged["got"]
    assert got.shape == want.shape == (2, 16, 16, 3) and np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


def test_flagged_gradient_matches_jax(flagged):
    tmodel, want = flagged["tmodel"], flagged["want_grads"]
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for name, p in tmodel.named_parameters():
        w = np.asarray(want[name])
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-6 * top, (name, err, np.abs(w).max())
    dx, want_dx = flagged["got_dx"], flagged["want_dx"]
    assert np.abs(dx - want_dx).max() <= 1e-4 * np.abs(want_dx).max()


def test_flagged_bf16_compute_near_f32_jax(flagged):
    tmodel = flagged["tmodel"]
    x, t, y = flagged["inputs"]
    tmodel.compute_dtype = torch.bfloat16
    try:
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    finally:
        tmodel.compute_dtype = None
    want = flagged["want"]
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 3e-2
