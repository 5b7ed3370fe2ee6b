"""Parity of the port's DiT (vaw_torch/models) with the JAX package's
(vaw_tpu/models) on the same weights and inputs.

Weights are made by the Flax model's init and then replaced by seeded numpy
noise, the adaLN-Zero modulation and the zero-initialised head included
(vaw_tpu/models/dit.py:50-51, :82-91): at their init the output would be
identically zero and the comparison would prove nothing. They reach the
port through vaw_torch.models.convert.flax_dit_to_torch.

Tolerances: f32 forward atol 1e-4 (f32 on both sides, JAX at "highest"
matmul precision); the port's bf16 forward against the f32 JAX forward
within 3e-2 of the output's largest magnitude (bf16 keeps 8 bits, and the
error grows through the residual stream of the blocks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models.convert import flax_dit_to_torch
from vaw_torch.models.dit import DiT
from vaw_torch.models import layers as tl
from vaw_tpu.models import layers as jl
from vaw_tpu.models.dit import DiT as JaxDiT

TINY = dict(image_size=32, patch_size=2, in_channels=4, hidden_size=128,
            depth=2, num_heads=2, num_classes=10, class_dropout_prob=0.1)


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf: kernels ~ 1/sqrt(fan_in),
    biases and tables ~ 0.05-0.3 so that labels and shifts matter."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for path, leaf in flat:
        names = [getattr(p, "key", str(p)) for p in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
        elif names[-1] == "embedding":
            std = 0.3
        else:
            std = 0.05
        node = out
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def _tiny_pair(seed=0):
    jmodel = JaxDiT(**TINY)
    x = jnp.zeros((2, 32, 32, 4))
    params = jmodel.init(jax.random.key(0), x, jnp.zeros((2,)),
                         jnp.zeros((2,), jnp.int32))["params"]
    params = _randomize(params, seed)
    tmodel = DiT(**TINY)
    tmodel.load_state_dict(flax_dit_to_torch(params), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(n=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32, 32, 4)).astype(np.float32)
    t = rng.uniform(0, 999, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, t, y


def test_timestep_embedding_matches():
    t = np.array([0.0, 1.5, 250.0, 999.0], np.float32)
    for dim in (256, 33):
        want = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
        got = tl.timestep_embedding(torch.from_numpy(t), dim).numpy()
        # cos/sin of f32 arguments up to ~1e3, whose ulp is 6e-5: the two
        # libraries' range reductions differ by about that much.
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dim,grid", [(128, 16), (768, 16), (64, 4)])
def test_pos_embed_bit_equal(dim, grid):
    np.testing.assert_array_equal(tl.get_2d_sincos_pos_embed(dim, grid),
                                  jl.get_2d_sincos_pos_embed(dim, grid))


def test_patch_embed_matches_nhwc():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jmod = jl.PatchEmbed(patch_size=2, embed_dim=16)
    params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tl.PatchEmbed(4, 2, 16)
    kernel = np.asarray(params["Conv_0"]["kernel"])  # HWIO
    with torch.no_grad():
        tmod.proj.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        tmod.proj.bias.copy_(torch.from_numpy(np.array(params["Conv_0"]["bias"])))
    got = tmod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 16, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_modulate_matches():
    rng = np.random.default_rng(3)
    x, shift, scale = (rng.standard_normal(s).astype(np.float32)
                       for s in ((2, 5, 8), (2, 8), (2, 8)))
    want = np.asarray(jl.modulate(jnp.asarray(x), jnp.asarray(shift),
                                  jnp.asarray(scale)))
    got = tl.modulate(*(torch.from_numpy(a) for a in (x, shift, scale))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_tiny_dit_forward_f32_matches():
    jmodel, params, tmodel = _tiny_pair()
    x, t, y = _inputs()
    want, _ = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(y))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(y).long())
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 4)
    assert np.abs(want).max() > 1e-2  # the randomised head is not trivial
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_tiny_dit_bf16_forward_near_f32_jax():
    jmodel, params, tmodel = _tiny_pair(seed=5)
    x, t, y = _inputs(seed=6)
    want, _ = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(y))
    want = np.asarray(want)
    tmodel = tmodel.to(torch.bfloat16)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(y).long())
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 3e-2, err


def test_convert_rejects_unmatched_and_missing():
    _, params, _ = _tiny_pair()
    # Dense_0-2 at the top level are the REPA projector's; a fourth has no rule.
    extra = dict(params, Dense_3={"kernel": np.zeros((128, 8), np.float32)})
    with pytest.raises(ValueError, match="no conversion rule"):
        flax_dit_to_torch(extra)
    partial = {k: v for k, v in params.items() if k != "FinalLayer_0"}
    with pytest.raises(ValueError, match="lack"):
        flax_dit_to_torch(partial)


def test_build_model_puts_every_tensor_on_the_device():
    from vaw_torch.models import build_model
    from vaw_torch.utils.config import TrainConfig

    cfg = TrainConfig(model="DiT-S", image_size=8, patch_size=2, in_chans=4,
                      num_classes=10, class_cond=True, drop_label_prob=0.1)
    model = build_model(cfg, device="meta")
    tensors = list(model.parameters()) + list(model.buffers())
    assert model.pos_embed.shape == (16, 384)
    assert {t.device.type for t in tensors} == {"meta"}
    assert model.y_embedder.embedding_table.weight.shape == (11, 384)
