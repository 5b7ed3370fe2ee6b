"""Parity of the port's ADM UNet (vaw_torch/models/unet.py) with the JAX
package's (vaw_tpu/models/unet.py) on the same weights and inputs, its
nearest-2x upsample + conv (vaw_torch/ops/upsample_conv.py), its parameter
counts, its switches and its Flax -> torch converter.

The small UNet has LDM's structure at a narrow width: 4-channel 32x32
latents, 32 model channels, channel_mult (1, 2), one res block a level,
scale-shift norm, resblock up/down, the 512-wide time embedding of a latent
UNet, 10 classes with the null row, and attention at the 16x16 level (64
channels, heads of 8), so its attention blocks take the p5 route (T = 256;
on the CPU its plain versions). Weights are made by the Flax model's init and
replaced by seeded numpy noise, the zero-initialised convs and projections
included (else the output is the identity or zero and proves nothing), then
cross through vaw_torch.models.convert.flax_unet_to_torch.

Tolerances: the f32 forward within 1e-4 of max|out| (f32 on both sides,
JAX at "highest" precision, different summation order); the port's bf16
compute against the f32 JAX forward within 3e-2 of max|out| (bf16 keeps 8
bits, through some 20 convs); the upsample + conv within 1e-5 (one conv,
f32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models import build_model, cast_for_compute
from vaw_torch.models import unet as port_unet
from vaw_torch.models.convert import flax_to_torch, flax_unet_to_torch
from vaw_torch.models.layers import FusedUpsampleConv, GroupNorm32
from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops import upsample_conv as port_upsample
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.models.convert import _legacy_qkv_perm, convert_unet
from vaw_tpu.models.unet import UNet_models as JaxUNet_models
from vaw_tpu.models.unet import UNetModel as JaxUNet
from vaw_tpu.ops import upsample_conv as jax_upsample

SMALL = dict(image_size=32, in_channels=4, model_channels=32, out_channels=4,
             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
             num_head_channels=8, num_classes=10, drop_label_prob=0.1)

# JAX eval_shape counts at 1000 classes with the null row.
PARAM_COUNTS = {"UNet-32": 44_686_339, "ADM-32": 57_603_715, "ADM-64": 295_900_035,
                "ADM-128": 421_523_715, "ADM-256": 553_832_195,
                "ADM-512": 558_995_203, "UNet-64": 129_143_235, "LDM": 274_459_140}


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


def _pair(seed=0, **overrides):
    kw = dict(SMALL, **overrides)
    jmodel = JaxUNet(**kw)
    y = jnp.zeros((1,), jnp.int32) if kw["num_classes"] > 0 else None
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                         y)["params"]
    params = _randomize(params, seed)
    tmodel = port_unet.UNetModel(**kw)
    tmodel.load_state_dict(flax_unet_to_torch(params, tmodel), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(n=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32, 32, 4)).astype(np.float32)
    t = rng.uniform(0, 999, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, t, y


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


@pytest.mark.parametrize("case", ["conditional", "unconditional", "force_drop_ids",
                                  "learn_sigma"])
def test_small_unet_forward_f32_matches(case, monkeypatch):
    overrides = {"unconditional": dict(num_classes=0),
                 "learn_sigma": dict(out_channels=8)}.get(case, {})
    jmodel, params, tmodel = _pair(**overrides)
    x, t, y = _inputs()
    if case == "unconditional":
        y = None
    drop = np.array([1, 0], np.int32) if case == "force_drop_ids" else None
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                        None if y is None else jnp.asarray(y),
                        force_drop_ids=None if drop is None else jnp.asarray(drop))
    p5 = []
    real = port_flash._FlashP5.apply
    monkeypatch.setattr(port_flash._FlashP5, "apply",
                        lambda *a: p5.append(a[0].shape) or real(*a))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                     None if y is None else torch.from_numpy(y).long(),
                     force_drop_ids=None if drop is None else torch.from_numpy(drop))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 8 if
                                                       case == "learn_sigma" else 4)
    _close(got.numpy(), want, 1e-4)
    # Four attention blocks at 16x16 (the encoder's, the middle one and two
    # in the decoder), 8 heads of 8.
    assert p5 == [(2, 3, 8, 8, 256)] * 4


def test_force_drop_ids_select_the_null_row():
    _, _, tmodel = _pair()
    x, t, y = _inputs()
    xs, ts = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        dropped = tmodel(xs, ts, torch.from_numpy(y).long(),
                         force_drop_ids=torch.ones(2, dtype=torch.int32))
        null = tmodel(xs, ts, torch.full((2,), 10))
    torch.testing.assert_close(dropped, null, rtol=0, atol=0)
    assert tmodel.label_emb.weight.shape == (11, 512)
    assert tmodel.has_null_label and not _pair(drop_label_prob=0.0)[2].has_null_label


def test_small_unet_bf16_compute_near_f32_jax():
    jmodel, params, tmodel = _pair(seed=5)
    x, t, y = _inputs(seed=6)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    tmodel.compute_dtype = torch.bfloat16
    with torch.no_grad():
        got = tmodel(*args)  # f32 masters, bf16 compute (the trainer's form)
        _close(got.numpy(), want, 3e-2)
        sampler = cast_for_compute(tmodel, torch.bfloat16)  # the sampler's copy
        assert sampler.out[0].weight.dtype == torch.float32
        assert sampler.out[2].weight.dtype == torch.float32
        norms = [m for m in sampler.modules() if isinstance(m, GroupNorm32)]
        assert len(norms) == 2 * 10 + 4 + 1  # two a ResBlock, one an attention, out
        assert all(m.weight.dtype == m.bias.dtype == torch.float32 for m in norms)
        assert sampler.middle_block[1].qkv.weight.dtype == torch.bfloat16
        assert sampler.input_blocks[0][0].weight.dtype == torch.bfloat16
        assert sampler.label_emb.weight.dtype == torch.bfloat16
        sampler.compute_dtype = None  # then it computes in its weights' dtype
        seen = []
        sampler.middle_block.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
        again = sampler(*args)
    assert seen == [torch.bfloat16] and again.dtype == torch.float32
    _close(again.numpy(), want, 3e-2)


@pytest.mark.parametrize("fused", [False, True])
def test_upsample_conv_matches_jax(fused):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    w3 = (rng.standard_normal((3, 3, 6, 4)) / 7).astype(np.float32)
    jax_fn = jax_upsample.nearest2x_conv3x3 if fused else \
        jax_upsample.nearest2x_conv3x3_reference
    port_fn = port_upsample.nearest2x_conv3x3 if fused else \
        port_upsample.nearest2x_conv3x3_reference
    want = jax_fn(jnp.asarray(x), jnp.asarray(w3))
    got = port_fn(torch.from_numpy(x), torch.from_numpy(w3))
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        port_upsample.upsample_nearest2x(torch.from_numpy(x)).numpy(),
        np.asarray(jax_upsample.upsample_nearest2x(jnp.asarray(x))))


def test_fused_upsample_switch_keeps_values_and_grads(monkeypatch):
    torch.manual_seed(0)
    conv = FusedUpsampleConv(6, 4)
    x = torch.randn(2, 5, 5, 6, requires_grad=True)
    outs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("VAW_FUSED_UPSAMPLE", flag)
        x.grad = None
        conv.zero_grad()
        y = conv(x)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        outs.append((y.detach(), x.grad.clone(), conv.weight.grad.clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_pallas_conv_state_dict_matches(monkeypatch):
    """VAW_PALLAS_CONV is a routing flag only: the state dict (names and
    shapes) is the same with it at 0 and at 1, the port's counterpart of
    tests/test_ops.py's test_pallas_conv_param_tree_matches_xla."""
    trees, routed = [], []
    for flag in ("0", "1"):
        monkeypatch.setenv("VAW_PALLAS_CONV", flag)
        model = port_unet.UNetModel(**SMALL)
        trees.append({k: tuple(v.shape) for k, v in model.state_dict().items()})
        routed.append(sum(isinstance(m, port_unet.PallasConv3x3) for m in model.modules()))
    assert trees[0] == trees[1]
    assert routed == [0, 1 + 2 * 10 - 1 + 1]  # stem, ResBlock convs, head


@pytest.mark.parametrize("name", sorted(PARAM_COUNTS))
def test_parameter_count_matches_jax(name):
    """Built on the meta device (shapes only), against JAX's eval_shape."""
    with torch.device("meta"):
        model = port_unet.UNet_models[name](num_classes=1000, drop_label_prob=0.1)
    jmodel = JaxUNet_models[name](num_classes=1000, drop_label_prob=0.1)
    s = jmodel.image_size
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, s, s, jmodel.in_channels)), jnp.zeros((1,)),
        jnp.zeros((1,), jnp.int32)))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert want == PARAM_COUNTS[name]
    assert sum(p.numel() for p in model.parameters()) == want


def test_flax_scopes_number_ldm_blocks_as_flax():
    with torch.device("meta"):
        model = port_unet.LDM(num_classes=1000, drop_label_prob=0.1)
    scopes = list(model.flax_scopes().values())
    assert sum(s.startswith("ResBlock_") for s in scopes) == 21
    assert sum(s.startswith("AttentionBlock_") for s in scopes) == 16
    heads = [m.num_heads for m in model.modules() if isinstance(m, port_unet.AttentionBlock)]
    assert sorted(set(heads)) == [8, 16, 32]  # heads of 32 at 32x32, 16x16, 8x8
    assert heads.count(16) == 5  # the five T = 256 blocks of the p5 kernels


def test_converter_round_trips_through_convert_unet():
    """The port's state dict, put in the reference's form (qkv and proj_out
    as 1x1 conv1d weights, qkv rows in the legacy per-head interleave),
    goes back through the JAX package's convert_unet to the same params."""
    _, params, tmodel = _pair(seed=7)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    for name in [k for k in sd if k.endswith(("qkv.weight", "qkv.bias"))]:
        c = sd[name].shape[0] // 3
        legacy = np.argsort(_legacy_qkv_perm(c, c // 8))
        sd[name] = sd[name][legacy]
    for name in [k for k in sd if k.endswith(("qkv.weight", "proj_out.weight"))]:
        sd[name] = sd[name][:, :, None]
    back = convert_unet(sd, num_head_channels=8)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    assert set(flax_to_torch(params, tmodel)) == set(tmodel.state_dict())


def test_converter_refuses_unmatched_and_missing():
    _, params, tmodel = _pair()
    with pytest.raises(ValueError, match="pass model="):
        flax_to_torch(params)
    with pytest.raises(ValueError, match="no conversion rule"):
        flax_unet_to_torch(dict(params, Dense_5={"kernel": np.zeros((4, 4))}), tmodel)
    block = dict(params["ResBlock_0"])
    block.pop("Conv_1")
    with pytest.raises(ValueError, match="lack"):
        flax_unet_to_torch(dict(params, ResBlock_0=block), tmodel)


def test_build_model_wires_the_unet_family():
    cfg = TrainConfig(model="LDM", image_size=32, in_chans=4, num_classes=1000,
                      class_cond=True, drop_label_prob=0.1)
    with torch.device("meta"):  # shapes only: no 274M-parameter init on the CPU
        model = build_model(cfg, device="meta")
    assert model.compute_dtype == torch.bfloat16
    assert model.label_emb.weight.shape == (1001, 512)  # the 512-wide latent embedding
    assert model.time_embed[0].weight.shape == (512, 256)
    assert model.out[2].weight.shape == (4, 256, 3, 3)
    cfg.learn_sigma = True
    with torch.device("meta"):
        assert build_model(cfg, device="meta").out[2].weight.shape == (8, 256, 3, 3)
    cfg.use_checkpoint, cfg.remat_policy = True, "dots"
    with torch.device("meta"):
        rematted = build_model(cfg, device="meta")
    assert rematted.use_checkpoint and rematted.output_blocks[0].remat == "dots"
    for name, item in (("EncoderUNet-64", "A15"), ("SuperRes-64", "A15")):
        cfg.model = name
        with pytest.raises(NotImplementedError, match=item):
            build_model(cfg, device="meta")
