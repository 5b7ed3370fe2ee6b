"""Parity of the port's REPA teachers (vaw_torch/encoders) with the JAX
package's (vaw_tpu/encoders): each of the seven families' forward, the timm
and CLIP converters, the position-table resampler, the pixel preprocessing
at 256 -> 224 and 32 -> 224, get_feature's token slicing, and the loader on
a checkpoint file.

Teachers are the "s" size (384 wide, 6 heads of 64) with depth cut to 2, on
a 2x2 patch grid at each family's patch size (tests/test_encoders.py:23-30).
Their weights are a seeded timm (or CLIP) state dict read by both
packages' converters. On the CPU both compute the attention in plain f32.

Tolerances: the f32 forward within atol 1e-4 (tests/test_torch_dit.py:82);
preprocess_raw_image within atol 1e-4 on the normalised pixels;
resample_pos_embed and the converters exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.encoders import (
    FAMILY_CONFIGS,
    FeatureViT,
    convert_clip_vit,
    convert_timm_vit,
    get_feature,
    load_encoders,
    mocov3_sincos_pos_embed,
    preprocess_raw_image,
    resample_pos_embed,
    runtime_image_size,
)
from vaw_torch.encoders import loaders as tloaders
from vaw_tpu import encoders as jenc
from vaw_tpu.encoders.vit_backbone import FeatureViT as JaxFeatureViT

DIM, HEADS, DEPTH = 384, 6, 2
ATOL = 1e-4
FAMILIES = ["dinov2", "dinov2reg", "dinov1", "mae", "mocov3", "jepa", "clip"]


def _timm_sd(patch, grid, *, cls=True, registers=0, layer_scale=False,
             gamma_names=False, depth=DEPTH, dim=DIM, seed=0):
    """A seeded timm/DINO-style ViT state dict with a pos table for a
    grid x grid patch grid (plus the cls row)."""
    rng = np.random.default_rng(seed)

    def r(*shape, std=0.05, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(dim, 3, patch, patch, std=1 / (patch * np.sqrt(3))),
          "patch_embed.proj.bias": r(dim),
          "pos_embed": r(1, int(cls) + grid * grid, dim, std=0.3),
          "norm.weight": r(dim, mean=1.0, std=0.1), "norm.bias": r(dim)}
    if cls:
        sd["cls_token"] = r(1, 1, dim, std=0.3)
    if registers:
        sd["register_tokens"] = r(1, registers, dim, std=0.3)
    for i in range(depth):
        p = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = r(dim, mean=1.0, std=0.1)
            sd[f"{p}.{n}.bias"] = r(dim)
        for n, (o, k) in {"attn.qkv": (3 * dim, dim), "attn.proj": (dim, dim),
                          "mlp.fc1": (4 * dim, dim), "mlp.fc2": (dim, 4 * dim)}.items():
            sd[f"{p}.{n}.weight"] = r(o, k, std=1 / np.sqrt(k))
            sd[f"{p}.{n}.bias"] = r(o)
        if layer_scale:
            for j in (1, 2):
                name = f"{p}.gamma_{j}" if gamma_names else f"{p}.ls{j}.gamma"
                sd[name] = r(dim, mean=0.5, std=0.1)
    return sd


def _clip_sd(patch, grid, depth=DEPTH, dim=DIM, seed=0):
    """A seeded CLIP visual-tower state dict, ``visual.``-prefixed, with
    ln_post and proj, which the converters drop."""
    rng = np.random.default_rng(seed)

    def r(*shape, std=0.05, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    sd = {"conv1.weight": r(dim, 3, patch, patch, std=1 / (patch * np.sqrt(3))),
          "class_embedding": r(dim, std=0.3),
          "positional_embedding": r(1 + grid * grid, dim, std=0.3),
          "ln_pre.weight": r(dim, mean=1.0, std=0.1), "ln_pre.bias": r(dim),
          "ln_post.weight": r(dim), "ln_post.bias": r(dim), "proj": r(dim, 16)}
    for i in range(depth):
        p = f"transformer.resblocks.{i}"
        for n in ("ln_1", "ln_2"):
            sd[f"{p}.{n}.weight"] = r(dim, mean=1.0, std=0.1)
            sd[f"{p}.{n}.bias"] = r(dim)
        sd[f"{p}.attn.in_proj_weight"] = r(3 * dim, dim, std=1 / np.sqrt(dim))
        sd[f"{p}.attn.in_proj_bias"] = r(3 * dim)
        for n, (o, k) in {"attn.out_proj": (dim, dim), "mlp.c_fc": (4 * dim, dim),
                          "mlp.c_proj": (dim, 4 * dim)}.items():
            sd[f"{p}.{n}.weight"] = r(o, k, std=1 / np.sqrt(k))
            sd[f"{p}.{n}.bias"] = r(o)
    return {f"visual.{k}": v for k, v in sd.items()}


def _family_sd(family, patch, grid, seed=0):
    cfg = FAMILY_CONFIGS[family]
    if family == "clip":
        return _clip_sd(patch, grid, seed=seed)
    return _timm_sd(patch, grid, cls=cfg.get("use_cls_token", True),
                    registers=cfg.get("num_register_tokens", 0),
                    layer_scale=cfg.get("layer_scale", False), seed=seed)


def _convert_both(family, sd, target_grid=None):
    cfg = FAMILY_CONFIGS[family]
    if family == "clip":
        return (jenc.convert_clip_vit(sd, DEPTH, target_grid=target_grid),
                convert_clip_vit(sd, DEPTH, target_grid=target_grid))
    kw = dict(depth=DEPTH, layer_scale=cfg.get("layer_scale", False),
              use_cls_token=cfg.get("use_cls_token", True),
              pre_norm=cfg.get("pre_norm", False),
              final_norm=cfg.get("final_norm", True), target_grid=target_grid)
    return jenc.convert_timm_vit(sd, **kw), convert_timm_vit(sd, **kw)


def _flax_to_port(params) -> dict:
    """The JAX FeatureViT's params under the port's names (the inverse of
    what each package's converter does), to hold the converters equal."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        keys = [getattr(k, "key", str(k)) for k in path]
        v = np.asarray(v)
        if keys[0] == "patch_embed":
            out[f"patch_embed.proj.{'weight' if keys[1] == 'kernel' else 'bias'}"] = (
                v.transpose(3, 2, 0, 1) if keys[1] == "kernel" else v)
        elif keys[0].startswith("block_"):
            p = f"blocks.{keys[0][len('block_'):]}"
            if keys[1] in ("ls1", "ls2"):
                out[f"{p}.{keys[1]}"] = v
            elif keys[1] in ("norm1", "norm2"):
                out[f"{p}.{keys[1]}.{'weight' if keys[2] == 'scale' else 'bias'}"] = v
            else:
                name = {("attn", "Dense_0"): "attn.qkv", ("attn", "Dense_1"): "attn.proj",
                        ("mlp", "Dense_0"): "mlp.fc1",
                        ("mlp", "Dense_1"): "mlp.fc2"}[(keys[1], keys[2])]
                out[f"{p}.{name}.{'weight' if keys[3] == 'kernel' else 'bias'}"] = (
                    v.T if keys[3] == "kernel" else v)
        elif keys[0] in ("norm", "ln_pre"):
            out[f"{keys[0]}.{'weight' if keys[1] == 'scale' else 'bias'}"] = v
        else:
            out[keys[0]] = v
    return out


def _assert_same(port: dict, jax_params):
    want = _flax_to_port(jax_params)
    assert set(port) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(port[k].numpy(), v, err_msg=k)


def _teachers(family, size):
    cfg = dict(FAMILY_CONFIGS[family])
    jmodel = JaxFeatureViT(image_size=size, embed_dim=DIM, depth=DEPTH, num_heads=HEADS,
                           **cfg)
    tmodel = FeatureViT(image_size=size, embed_dim=DIM, depth=DEPTH, num_heads=HEADS,
                        **cfg)
    return jmodel, tmodel


@pytest.mark.parametrize("family", FAMILIES)
def test_family_forward_matches_jax(family):
    patch = FAMILY_CONFIGS[family]["patch_size"]
    size = 2 * patch
    sd = _family_sd(family, patch, 2)
    jparams, tparams = _convert_both(family, sd)
    _assert_same(tparams, jparams)
    jmodel, tmodel = _teachers(family, size)
    tmodel.load_state_dict(tparams, strict=True)
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    extra = {"jepa": 0, "dinov2reg": 5}.get(family, 1)
    assert got.shape == want.shape == (2, extra + 4, DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layer_scale,gamma_names", [(False, False), (True, False),
                                                     (True, True)],
                         ids=["plain", "ls_gamma", "gamma_n"])
def test_timm_converter_matches_jax_exactly(layer_scale, gamma_names):
    """With and without layer scale (timm's ls{j}.gamma and DINO's
    gamma_{j}), with the table resampled from a 37-grid (DINOv2's 518 px
    table) to 16."""
    sd = _timm_sd(14, 37, layer_scale=layer_scale, gamma_names=gamma_names, dim=32,
                  seed=3)
    kw = dict(depth=DEPTH, layer_scale=layer_scale, target_grid=16)
    _assert_same(convert_timm_vit(sd, **kw), jenc.convert_timm_vit(sd, **kw))


def test_clip_converter_resamples_exactly():
    sd = _clip_sd(14, 16, dim=32, seed=4)
    for grid in (None, 12):
        got = convert_clip_vit(sd, DEPTH, target_grid=grid)
        _assert_same(got, jenc.convert_clip_vit(sd, DEPTH, target_grid=grid))
        assert got["pos_embed"].shape == (1, 1 + (grid or 16) ** 2, 32)


@pytest.mark.parametrize("src,dst,prefix", [(14, 16, 1), (37, 16, 1), (16, 14, 1),
                                            (16, 16, 1), (16, 12, 0)])
def test_resample_pos_embed_matches_jax_exactly(src, dst, prefix):
    pos = np.random.default_rng(5).standard_normal((1, prefix + src * src, 24))
    pos = pos.astype(np.float32)
    got = resample_pos_embed(pos, dst, prefix)
    np.testing.assert_array_equal(got, jenc.resample_pos_embed(pos, dst, prefix))
    assert got.shape == (1, prefix + dst * dst, 24)
    with pytest.raises(ValueError, match="not square"):
        resample_pos_embed(pos[:, :-1], dst, prefix)


def test_mocov3_table_matches_jax_exactly():
    np.testing.assert_array_equal(mocov3_sincos_pos_embed(64, 5),
                                  jenc.mocov3_sincos_pos_embed(64, 5))


@pytest.mark.parametrize("enc_type", ["dinov2-vit-b", "clip-vit-l", "jepa-vit-h",
                                      "mae-vit-b", "dinov2-vit-b,clip-vit-l"])
@pytest.mark.parametrize("resolution", [256, 32])
def test_preprocess_raw_image_matches_jax(enc_type, resolution):
    """256 -> 224 (the latent recipe's pixels) and 32 -> 224 (pixel
    datasets); mae takes its pixels unresized; a spec list uses its first
    spec alone."""
    x = np.random.default_rng(6).uniform(0, 255, (2, resolution, resolution, 3))
    x = x.astype(np.float32)
    want = np.asarray(jenc.preprocess_raw_image(jnp.asarray(x), enc_type))
    got = preprocess_raw_image(torch.from_numpy(x), enc_type).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got.shape[1] == runtime_image_size(enc_type.split("-")[0], resolution)


@pytest.mark.parametrize("family", ["mocov3", "dinov2reg", "jepa", "mae"])
def test_get_feature_slices_as_jax(family):
    """Patch tokens only: the cls token (and dinov2reg's 4 registers) are
    dropped, jepa's tokens are all patches. 32 px pixels: mocov3 and mae
    take them as they are (a 2x2 grid), dinov2reg and jepa resized to 224
    (16x16)."""
    patch = FAMILY_CONFIGS[family]["patch_size"]
    size = runtime_image_size(family, 32)
    grid = size // patch
    jparams, tparams = _convert_both(family, _family_sd(family, patch, grid, seed=7))
    jmodel, tmodel = _teachers(family, size)
    tmodel.load_state_dict(tparams, strict=True)
    enc_type = f"{family}-vit-s"
    pixels = np.random.default_rng(8).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jenc.get_feature(
        enc_type, jnp.asarray(pixels), lambda x: jmodel.apply({"params": jparams}, x)))
    got = get_feature(enc_type, torch.from_numpy(pixels), tmodel)
    assert got.shape == want.shape == (2, grid * grid, DIM)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _small_sizes(monkeypatch):
    """The "s" size cut to width 64, depth 2, 2 heads."""
    from vaw_torch.encoders import vit_backbone

    monkeypatch.setitem(vit_backbone._SIZES, "s", (64, 2, 2))


@pytest.mark.parametrize("family,wrap", [("dinov2", None), ("mocov3", "state_dict"),
                                         ("mae", "model"), ("clip", None)])
def test_load_encoders_reads_a_checkpoint_file(family, wrap, tmp_path, monkeypatch):
    """load_encoders on a .pth in VAW_ENCODER_DIR, at 256 px pixels: the
    checkpoint unwrapped (MoCo-v3's state_dict with its DDP prefix, MAE's
    model), its table resampled from a 37-grid to the runtime grid, the
    teacher frozen in eval mode on the device, equal to the model the
    converter's state dict makes."""
    _small_sizes(monkeypatch)
    patch = 16 if family == "clip" else FAMILY_CONFIGS[family]["patch_size"]
    sd = (_clip_sd(patch, 37, dim=64, seed=9) if family == "clip"
          else _timm_sd(patch, 37, layer_scale=family == "dinov2", dim=64, seed=9))
    saved = {k: torch.from_numpy(v) for k, v in sd.items()}
    if wrap == "state_dict":
        saved = {"state_dict": {f"module.base_encoder.{k}": v for k, v in saved.items()},
                 "epoch": 3}
    elif wrap == "model":
        saved = {"model": saved}
    torch.save(saved, tmp_path / f"{family}-vit-s.pth")
    monkeypatch.setenv("VAW_ENCODER_DIR", str(tmp_path))
    (teacher,), archs, families = load_encoders(f"{family}-vit-s", 256, device="cpu")
    assert archs == ["vit"] and families == [family]
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    grid = runtime_image_size(family, 256) // patch
    assert teacher.pos_embed.shape == (1, 1 + grid * grid, 64)
    cfg = dict(FAMILY_CONFIGS[family], patch_size=patch)
    if family == "clip":
        want = convert_clip_vit(sd, 2, target_grid=grid)
    else:
        want = convert_timm_vit(sd, 2, layer_scale=cfg.get("layer_scale", False),
                                final_norm=cfg.get("final_norm", True), target_grid=grid)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_load_encoders_names_missing_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_ENCODER_DIR", str(tmp_path))
    assert tloaders.find_encoder_weights("dinov2", "b") is None
    with pytest.raises(FileNotFoundError, match="dinov2-vit-b"):
        load_encoders("dinov2-vit-b", 256, device="cpu")
    with pytest.raises(ValueError, match="bad encoder spec"):
        load_encoders("dinov2-b", 256, device="cpu")
