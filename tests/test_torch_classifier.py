"""Parity of the port's classifier-guidance and super-resolution models
(vaw_torch/models/unet.py: EncoderUNetModel with its four pools,
AttentionPool2d, SuperResModel) with the JAX package's on the same weights
and inputs, the port's classifier loader (vaw_torch/samplers/classifier.py)
against the JAX loader on one .pt, and --use_classifier through the port's
sampling CLI (the counterpart of tests/test_classifier_cli.py).

Weights come from the Flax model's init, replaced by seeded numpy noise
(the zero-initialised convs and heads included) and carried across with
vaw_torch.models.convert. Tolerance: f32 on both sides, JAX at "highest"
precision; outputs within 1e-4 of max|out| (different summation order);
the bilinear upsample of SuperResModel within 1e-5 (a lerp of two lerps).
"""

from __future__ import annotations

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.cli import main as train_cli
from vaw_torch.cli import sample as sample_cli
from vaw_torch.models import unet as port_unet
from vaw_torch.models.convert import (
    _legacy_qkv_perm,
    flax_encoder_unet_to_torch,
    flax_to_torch,
)
from vaw_torch.samplers import classifier as port_classifier
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.models import unet as jax_unet
from vaw_tpu.samplers import classifier as jax_classifier

ENC = dict(image_size=16, in_channels=3, model_channels=16, out_channels=5,
           num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
           num_head_channels=8)
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test (the suite runs several test processes
    side by side), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf: kernels ~ 1/sqrt(fan_in),
    GroupNorm scales ~ 1 + 0.1 N, everything else ~ 0.05 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        return (z * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _inputs(n=2, size=16, c=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, c)).astype(np.float32)
    t = np.array([3.0, 777.0][:n], np.float32)
    return x, t


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"relative error {err} > {rtol}"


def _encoder_pair(pool, seed=0):
    jmodel = jax_unet.EncoderUNetModel(**ENC, pool=pool)
    x, t = _inputs()
    params = _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t))
                        ["params"], seed)
    tmodel = port_unet.EncoderUNetModel(**ENC, pool=pool)
    tmodel.load_state_dict(flax_encoder_unet_to_torch(params, tmodel), strict=True)
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_encoder_unet_pools_match_jax(pool):
    jmodel, params, tmodel = _encoder_pair(pool)
    x, t = _inputs()
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (2, 5)
    _close(got, want)
    # flax_to_torch picks the EncoderUNet rules from the model it is given
    sd = flax_to_torch(params, model=tmodel)
    assert all(torch.equal(sd[k], v) for k, v in tmodel.state_dict().items())


def test_encoder_unet_rejects_unknown_pool():
    with pytest.raises(NotImplementedError, match="pooling"):
        port_unet.EncoderUNetModel(**ENC, pool="max")


@pytest.mark.parametrize("hw,heads_ch", [(4, 8), (8, 16)])
def test_attention_pool_matches_jax(hw, heads_ch):
    rng = np.random.default_rng(hw)
    c = 32
    x = rng.standard_normal((3, hw, hw, c)).astype(np.float32)
    jmod = jax_unet.AttentionPool2d(num_head_channels=heads_ch, output_dim=7)
    params = _randomize(jmod.init(jax.random.key(0), jnp.asarray(x))["params"], hw)
    tmod = port_unet.AttentionPool2d(hw, c, heads_ch, 7)
    with torch.no_grad():
        tmod.positional_embedding.copy_(torch.from_numpy(
            np.asarray(params["positional_embedding"]).T.copy()))
        for name, dense in (("qkv_proj", "Dense_0"), ("c_proj", "Dense_1")):
            getattr(tmod, name).weight.copy_(torch.from_numpy(
                np.asarray(params[dense]["kernel"]).T.copy()))
            getattr(tmod, name).bias.copy_(torch.from_numpy(np.asarray(params[dense]["bias"])))
        got = tmod(torch.from_numpy(x))
    _close(got, jmod.apply({"params": params}, jnp.asarray(x)))


SR_UNET = dict(image_size=16, in_channels=6, model_channels=16, out_channels=3,
               num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
               num_head_channels=8, num_classes=4)


@pytest.mark.parametrize("low", [8, 4, 6])  # x2, x4 and 16/6, not an integer
def test_super_res_model_matches_jax(low):
    rng = np.random.default_rng(low)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    low_res = rng.standard_normal((2, low, low, 3)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    y = np.array([1, 3], np.int32)
    jmodel = jax_unet.SuperResModel(unet=jax_unet.UNetModel(**SR_UNET))
    params = _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                                    low_res=jnp.asarray(low_res), y=jnp.asarray(y))
                        ["params"], low)
    tmodel = port_unet.SuperResModel(port_unet.UNetModel(**SR_UNET)).eval()
    tmodel.load_state_dict(flax_to_torch(params, model=tmodel), strict=True)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                        low_res=jnp.asarray(low_res), y=jnp.asarray(y))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                     low_res=torch.from_numpy(low_res), y=torch.from_numpy(y).long())
    _close(got, want)
    # the upsampled low-res image itself: jax.image.resize's bilinear
    up = jax.image.resize(jnp.asarray(low_res), (2, 16, 16, 3), method="bilinear")
    got_up = torch.nn.functional.interpolate(
        torch.from_numpy(low_res).permute(0, 3, 1, 2), size=(16, 16), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_up.numpy(), np.asarray(up), atol=1e-5, rtol=0)


def test_super_res_model_needs_low_res():
    tmodel = port_unet.SuperResModel(port_unet.UNetModel(**SR_UNET))
    with pytest.raises(ValueError, match="low_res"):
        tmodel(torch.zeros(1, 16, 16, 3), torch.zeros(1), y=torch.zeros(1).long())


# --------------------------------------------------------------- loading


def _tiny_unet(num_classes=3, in_channels=3, dropout=0, learn_sigma=False,
               class_cond=True, drop_label_prob=0.0, **kwargs):
    return dict(image_size=8, num_channels=16, num_res_blocks=1,
                attention_resolutions="4", num_head_channels=8, channel_mult="1,2",
                num_classes=num_classes, dropout=dropout, in_channels=in_channels,
                drop_label_prob=drop_label_prob, learn_sigma=learn_sigma,
                class_cond=class_cond, **kwargs)


def _port_tiny_unet(**kw):
    return port_unet.create_unet_model(**_tiny_unet(**kw))


def _jax_tiny_unet(**kw):
    return jax_unet.create_unet_model(**_tiny_unet(**kw))


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    monkeypatch.setitem(port_unet.UNet_models, "UNet-32", _port_tiny_unet)
    monkeypatch.setitem(jax_unet.UNet_models, "UNet-32", _jax_tiny_unet)
    return "UNet-32"


def _cfg(path, model="UNet-32"):
    return TrainConfig(model=model, image_size=8, in_chans=3, num_classes=3,
                       class_cond=True, use_classifier=str(path), guidance_scale=2.0)


def _reference_layout(sd, model):
    """The port's classifier state dict in the reference's layout (1-d conv
    attention weights, legacy head-interleaved qkv rows): the inverse of
    reference_encoder_unet_to_torch."""
    out = {}
    for name, v in sd.items():
        if name.endswith(("qkv.weight", "qkv.bias")) and not name.startswith("out."):
            heads = model.get_submodule(name.rsplit(".", 2)[0]).num_heads
            legacy = torch.empty_like(v)
            legacy[torch.from_numpy(_legacy_qkv_perm(v.shape[0] // 3, heads))] = v
            v = legacy
        if name.endswith(("qkv.weight", "proj_out.weight", "qkv_proj.weight",
                          "c_proj.weight")):
            v = v[..., None]
        out[name] = v.clone()
    return out


def test_build_classifier_from_reference_pt_matches_jax(tiny_registry, tmp_path):
    cfg = _cfg(tmp_path / "clf.pt")
    torch.manual_seed(0)
    model = port_classifier.make_classifier_model(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():  # no zero head: the logits must move
            p.add_(0.05 * torch.randn_like(p))
    torch.save(_reference_layout(model.state_dict(), model), cfg.use_classifier)
    classifier_fn, loaded = port_classifier.build_classifier(cfg, device="cpu")
    assert not any(p.requires_grad for p in loaded.parameters())
    assert loaded.pool == "attention" and loaded.out[2].num_heads == 4
    jfn, _ = jax_classifier.build_classifier(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([5.0, 600.0], np.float32)
    got = classifier_fn(torch.from_numpy(x), torch.from_numpy(t)).detach()
    _close(got, jfn(jnp.asarray(x), jnp.asarray(t)))
    # the port's own layout loads as it is, to the same logits
    port_classifier.save_classifier_checkpoint(str(tmp_path / "own.pt"), loaded)
    own_fn, _ = port_classifier.build_classifier(_cfg(tmp_path / "own.pt"), device="cpu")
    torch.testing.assert_close(own_fn(torch.from_numpy(x), torch.from_numpy(t)), got,
                               rtol=0, atol=0)


def test_build_classifier_refuses_what_it_cannot_read(tiny_registry, tmp_path):
    with pytest.raises(ValueError, match="UNet variant"):
        port_classifier.build_classifier(_cfg("/nonexistent.pt", model="DiT-S"),
                                         device="cpu")
    with pytest.raises(ValueError, match="flax_to_torch"):
        port_classifier.build_classifier(_cfg(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        port_classifier.build_classifier(_cfg(tmp_path / "missing.pt"), device="cpu")


# ------------------------------------------------------------------ CLI

TINY = ["--model", "UNet-32", "--image_size", "8", "--in_chans", "3",
        "--num_classes", "3", "--class_cond", "True"]


def test_sample_cli_with_classifier_guidance(tiny_registry, tmp_path):
    ctx = train_cli.main(TINY + [
        "--dataset", "Gaussian", "--batch_size", "8", "--total_steps", "2",
        "--sample_freq", "0", "--sample_steps", "2", "--diffusion_steps", "20",
        "--path_type", "cosine",
        "--save_step", "2", "--eval", "False", "--amp", "False", "--solver", "ddim",
        "--logdir", str(tmp_path / "train")])
    (ckpt,) = glob.glob(str(tmp_path / "train" / "*" / "checkpoint" / "*.pt"))
    clf = tmp_path / "clf.pt"
    torch.manual_seed(2)
    port_classifier.save_classifier_checkpoint(
        str(clf), port_classifier.make_classifier_model(ctx["trainer"].cfg, device="cpu"))
    save_path = tmp_path / "out"
    argv = TINY + ["--sample_steps", "2", "--diffusion_steps", "20", "--solver", "ddim",
                   "--path_type", "cosine",
                   "--num_samples", "2", "--sample_size", "2", "--resume", ckpt,
                   "--save_path", str(save_path), "--use_classifier", str(clf),
                   "--guidance_scale", "2.0"]
    sample_cli.main(argv)
    assert len(glob.glob(str(save_path / "*" / "*.png"))) == 2
    with pytest.raises(ValueError, match="requires --model_mode diffusion"):
        sample_cli.main(argv + ["--model_mode", "flow", "--mean_type", "VECTOR"])
