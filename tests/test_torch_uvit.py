"""Parity of the port's U-ViT (vaw_torch/models/uvit.py) with the JAX
package's (vaw_tpu/models/uvit.py) on the same weights and inputs, its
Flax -> torch converter, and its checkpoints.

The tiny U-ViT: embed 64, depth 5 (2 in-blocks, a mid block, 2 out-blocks
with long skips), 4 heads of 16, 8x8x4 images, patch 2, 10 classes, so
T = 2 extras + 16 patches = 18. Weights are made by the Flax model's init
and replaced by seeded numpy noise, then cross through
vaw_torch.models.convert.flax_uvit_to_torch.

Tolerances: the f32 forward within 1e-4 of max|out| (f32 on both sides,
JAX at "highest" matmul precision, different summation order); the port's
bf16 compute against the f32 JAX forward within 3e-2 of max|out| (bf16
keeps 8 bits, and the error grows through the residual stream).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models import build_model, cast_for_compute
from vaw_torch.models.convert import flax_to_torch, flax_uvit_to_torch
from vaw_torch.models.uvit import UViT
from vaw_torch.train import load_checkpoint, save_checkpoint
from vaw_torch.train.state import TrainState
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.models.convert import convert_uvit
from vaw_tpu.models.uvit import UViT as JaxUViT

TINY = dict(image_size=8, patch_size=2, in_channels=4, embed_dim=64, depth=5,
            num_heads=4, num_classes=10, class_dropout_prob=0.1)


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf: kernels ~ 1/sqrt(fan_in),
    LayerNorm scales ~ 1 + 0.1 N, tables and pos_embed ~ 0.3, biases ~ 0.05."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        std = 0.3 if name in ("embedding", "pos_embed") else 0.05
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(seed=0, **overrides):
    kw = dict(TINY, **overrides)
    jmodel = JaxUViT(**kw)
    y = jnp.zeros((2,), jnp.int32) if kw["num_classes"] > 0 else None
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)),
                         y)["params"]
    params = _randomize(params, seed)
    tmodel = UViT(**kw)
    tmodel.load_state_dict(flax_uvit_to_torch(params), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(n=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 4)).astype(np.float32)
    t = rng.uniform(0, 999, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, t, y


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


@pytest.mark.parametrize("case", ["conditional", "unconditional", "force_drop_ids",
                                  "mlp_time_embed"])
def test_tiny_uvit_forward_f32_matches(case):
    overrides = {"unconditional": dict(num_classes=0),
                 "mlp_time_embed": dict(mlp_time_embed=True)}.get(case, {})
    jmodel, params, tmodel = _pair(**overrides)
    x, t, y = _inputs()
    if case == "unconditional":
        y = None
    drop = np.array([1, 0, 1], np.int32) if case == "force_drop_ids" else None
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                        None if y is None else jnp.asarray(y),
                        force_drop_ids=None if drop is None else jnp.asarray(drop))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                     None if y is None else torch.from_numpy(y).long(),
                     force_drop_ids=None if drop is None else torch.from_numpy(drop))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)


def test_force_drop_ids_select_the_null_row():
    _, _, tmodel = _pair()
    x, t, y = _inputs()
    xs, ts = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        dropped = tmodel(xs, ts, torch.from_numpy(y).long(),
                         force_drop_ids=torch.ones(3, dtype=torch.int32))
        null = tmodel(xs, ts, torch.full((3,), 10))
    torch.testing.assert_close(dropped, null, rtol=0, atol=0)
    assert tmodel.has_null_label and not _pair(class_dropout_prob=0.0)[2].has_null_label


def test_tiny_uvit_bf16_compute_near_f32_jax():
    jmodel, params, tmodel = _pair(seed=5)
    x, t, y = _inputs(seed=6)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    tmodel.compute_dtype = torch.bfloat16
    with torch.no_grad():
        got = tmodel(*args)  # f32 masters, bf16 compute (the trainer's form)
        _close(got.numpy(), want, 3e-2)
        sampler = cast_for_compute(tmodel, torch.bfloat16)  # the sampler's copy
        assert sampler.decoder_pred.weight.dtype == torch.float32
        assert sampler.final_layer.weight.dtype == torch.float32
        assert sampler.norm.weight.dtype == torch.float32
        assert sampler.mid_block.attn.qkv.weight.dtype == torch.bfloat16
        assert sampler.pos_embed.dtype == torch.bfloat16
        again = sampler(*args)
    assert again.dtype == torch.float32
    _close(again.numpy(), want, 3e-2)


@pytest.mark.parametrize("mlp_time_embed", [False, True])
def test_converter_round_trips_through_convert_uvit(mlp_time_embed):
    _, params, tmodel = _pair(seed=7, mlp_time_embed=mlp_time_embed)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = convert_uvit(sd, depth=5, mlp_time_embed=mlp_time_embed)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    assert set(flax_to_torch(params)) == set(sd)


def test_converter_refuses_unmatched_and_missing():
    _, params, _ = _pair()
    extra = dict(params, Dense_5={"kernel": np.zeros((64, 8), np.float32)})
    with pytest.raises(ValueError, match="no conversion rule"):
        flax_uvit_to_torch(extra)
    block = dict(params["UViTBlock_3"])
    block.pop("Mlp_0")
    with pytest.raises(ValueError, match="lack"):
        flax_uvit_to_torch(dict(params, UViTBlock_3=block))
    with pytest.raises(ValueError, match="lack"):
        flax_uvit_to_torch({k: v for k, v in params.items() if k != "final_layer"})
    with pytest.raises(ValueError, match="UViTBlock_0..2k"):
        flax_uvit_to_torch({k: v for k, v in params.items() if k != "UViTBlock_4"})
    with pytest.raises(ValueError, match="no ported family"):
        flax_to_torch({"Dense_0": params["Dense_0"]})


@pytest.mark.parametrize("family", ["U-ViT", "DiT"])
def test_checkpoint_keeps_a_learned_pos_embed(family, tmp_path):
    """A U-ViT's learned pos_embed is saved and loaded back; the DiT's
    frozen table, stored by reference checkpoints, is still dropped."""
    cfg = TrainConfig(model="U-ViT-S" if family == "U-ViT" else "DiT-S", image_size=8,
                      patch_size=2, in_chans=4, num_classes=10, class_cond=True,
                      drop_label_prob=0.1, logdir=str(tmp_path))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    ema = {k: torch.randn_like(p) for k, p in params.items()}
    state = TrainState(step=3, params=params, ema=ema, count=3,
                       mu={k: torch.zeros_like(p) for k, p in params.items()},
                       nu={k: torch.zeros_like(p) for k, p in params.items()})
    path = save_checkpoint(cfg, 3, state)
    if family == "DiT":  # a reference-style file that also stores the table
        payload = torch.load(path, weights_only=True)
        payload["ema"]["pos_embed"] = torch.zeros(1, 16, 384)
        torch.save(payload, path)
    fresh = build_model(cfg, device="cpu")
    assert load_checkpoint(path, fresh) == 3
    for name, p in fresh.named_parameters():
        torch.testing.assert_close(p.detach(), ema[name], rtol=0, atol=0)
    if family == "U-ViT":
        assert "pos_embed" in ema and fresh.pos_embed.shape == (1, 18, 512)


def test_build_model_wires_the_uvit_family():
    cfg = TrainConfig(model="U-ViT-L", image_size=32, patch_size=2, in_chans=4,
                      num_classes=1000, class_cond=True, drop_label_prob=0.1)
    with torch.device("meta"):  # shapes only: no 287M-parameter init on the CPU
        model = build_model(cfg, device="meta")
    assert model.pos_embed.shape == (1, 258, 1024)
    assert len(model.in_blocks) == len(model.out_blocks) == 10
    assert model.label_emb.weight.shape == (1001, 1024)
    assert model.compute_dtype == torch.bfloat16
    assert model.mid_block.attn.qkv.bias is None
    n = sum(p.numel() for p in model.parameters())
    assert 280e6 < n < 290e6, n  # U-ViT-L: 287M (Bao et al., 2023, Table 1)
    cfg.class_cond = False
    with torch.device("meta"):
        assert build_model(cfg, device="meta").label_emb is None
    cfg.learn_sigma = True
    with pytest.raises(ValueError, match="learn_sigma"):
        build_model(cfg, device="meta")
