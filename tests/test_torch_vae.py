"""Parity of the port's SD-VAE (vaw_torch/models/vae.py, data/vae.py) with
the JAX package's (vaw_tpu/models/vae.py, data/vae.py): encode, decode,
the moments' re-sampling and storage layout, the diffusers converter, and
the decode in bf16; then the loader on a diffusers-layout .bin.

The tiny VAE of tests/test_vae.py:12-15 (base 32, mults (1, 2), one res
block, 4 latent channels) on 16x16 images; weights are the Flax init
replaced by seeded numpy noise, carried across by
vaw_torch.models.convert.flax_vae_to_torch, or a seeded diffusers state
dict read by both packages' convert_diffusers_vae.

Tolerances: the f32 encode and decode within atol 1e-4
(tests/test_torch_dit.py:82), outputs of order 1-4; the converters exact;
the bf16 decode within JAX's own bf16-vs-f32 bound 0.1
(tests/test_vae.py:177) of the f32 decode and of the JAX bf16 decode.
"""

from __future__ import annotations

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.data import vae as tvae_data
from vaw_torch.models.convert import flax_vae_to_torch
from vaw_torch.models.vae import AutoencoderKL
from vaw_tpu.data.vae import convert_diffusers_vae as jax_convert
from vaw_tpu.models.vae import AutoencoderKL as JaxVAE

TINY = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1, latent_channels=4)
CONVERT = dict(channel_mults=(1, 2), num_res_blocks=1, base=32)
ATOL = 1e-4
BF16_BOUND = 0.1


def _randomize(params, seed):
    """Seeded noise in every leaf: conv and dense kernels ~ 1/sqrt(fan_in),
    norm scales ~ 1 + 0.1 N, biases ~ 0.05 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        return (0.05 * z).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxVAE(**TINY)
    rng = jax.random.key(0)
    x = jnp.zeros((1, 16, 16, 3))
    params = jmodel.init(rng, x, rng)["params"]
    params = _randomize(jax.tree_util.tree_map(np.asarray, params), seed=1)
    tmodel = AutoencoderKL(**TINY)
    tmodel.load_state_dict(flax_vae_to_torch(params), strict=True)
    return jmodel, params, tmodel.eval()


def _images(seed=2, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32)


def _latents(seed=3, n=2):
    return np.random.default_rng(seed).standard_normal((n, 8, 8, 4)).astype(np.float32)


def test_encode_matches_jax(pair):
    jmodel, params, tmodel = pair
    x = _images()
    want = jmodel.apply({"params": params}, jnp.asarray(x), method=jmodel.encode)
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(x))
    assert got.shape == (2, 8, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_decode_matches_jax(pair):
    jmodel, params, tmodel = pair
    z = _latents()
    want = jmodel.apply({"params": params}, jnp.asarray(z), method=jmodel.decode)
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_forward_with_fed_noise_matches_jax(pair):
    """The round trip x -> moments -> mean + std * eps -> decode, with eps
    fed to the port and the same eps applied to the JAX moments."""
    jmodel, params, tmodel = pair
    x = _images(seed=4)
    eps = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32)
    moments = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                      method=jmodel.encode))
    mean, logvar = np.split(moments, 2, axis=-1)
    z = mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * eps
    want = jmodel.apply({"params": params}, jnp.asarray(z), method=jmodel.decode)
    with torch.no_grad():
        recon, got_moments = tmodel(torch.from_numpy(x), noise=torch.from_numpy(eps))
    np.testing.assert_allclose(got_moments.numpy(), moments, atol=ATOL, rtol=0)
    np.testing.assert_allclose(recon.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_sample_latent_and_mean_std_match_jax():
    """Both static methods on moments whose logvar reaches past the clip
    range [-30, 20]; sample_latent with fed noise, and from a generator
    (same generator, same draw)."""
    rng = np.random.default_rng(6)
    moments = np.concatenate(
        [rng.standard_normal((2, 3, 3, 4)), rng.uniform(-40, 30, (2, 3, 3, 4))],
        axis=-1).astype(np.float32)
    want = JaxVAE.moments_to_mean_std(jnp.asarray(moments))
    got = AutoencoderKL.moments_to_mean_std(torch.from_numpy(moments))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    eps = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    mean, std = np.split(np.asarray(want), 2, axis=-1)
    fed = AutoencoderKL.sample_latent(torch.from_numpy(moments), noise=torch.from_numpy(eps))
    np.testing.assert_allclose(fed.numpy(), mean + std * eps, rtol=1e-6, atol=1e-6)
    a = AutoencoderKL.sample_latent(torch.from_numpy(moments),
                                    torch.Generator().manual_seed(7))
    b = AutoencoderKL.sample_latent(torch.from_numpy(moments),
                                    torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (2, 3, 3, 4)


def _diffusers_sd(seed=8, conv_attention=False):
    """A seeded diffusers AutoencoderKL state dict of the tiny configuration:
    every tensor of the port's model (diffusers' names) with random values;
    with `conv_attention` the attention projections in their 1x1-conv form."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in AutoencoderKL(**TINY).state_dict().items():
        shape = tuple(v.shape)
        if conv_attention and ".attentions.0.to_" in k and k.endswith(".weight"):
            shape = shape + (1, 1)
        sd[k] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return sd


@pytest.mark.parametrize("conv_attention", [False, True],
                         ids=["linear_attention", "conv_attention"])
def test_diffusers_converters_agree_exactly(conv_attention):
    sd = _diffusers_sd(conv_attention=conv_attention)
    want = flax_vae_to_torch(jax.tree_util.tree_map(np.asarray, jax_convert(sd, **CONVERT)))
    got = tvae_data.convert_diffusers_vae(sd, **CONVERT)
    assert set(got) == set(want) == set(AutoencoderKL(**TINY).state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_converter_names_a_missing_tensor():
    sd = _diffusers_sd()
    del sd["decoder.conv_out.bias"]
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        tvae_data.convert_diffusers_vae(sd, **CONVERT)


def test_bf16_decode_within_the_jax_bound(pair):
    """The sampler's bf16 decode: f32 out (conv_out runs in f32), within 0.1
    of the f32 decode and of the JAX bf16 decode on the same f32 weights."""
    _, params, tmodel = pair
    z = _latents(seed=9)
    jb16 = JaxVAE(**TINY, dtype=jnp.bfloat16)
    want16 = np.asarray(jb16.apply({"params": params}, jnp.asarray(z), method=jb16.decode))
    b16 = AutoencoderKL(**TINY, compute_dtype=torch.bfloat16)
    b16.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        out32 = tmodel.decode(torch.from_numpy(z)).numpy()
        out16 = b16.decode(torch.from_numpy(z))
    assert out16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in b16.parameters())
    out16 = out16.numpy()
    assert np.isfinite(out16).all()
    assert np.abs(out16 - out32).max() < BF16_BOUND
    assert np.abs(out16 - want16).max() < BF16_BOUND


def test_base_width_must_fit_the_norm_groups():
    with pytest.raises(ValueError, match="multiple of the 32"):
        AutoencoderKL(base_channels=48)


@pytest.fixture
def tiny_vae_files(monkeypatch):
    """The loader's full-size configuration replaced by the tiny one."""
    monkeypatch.setattr(tvae_data, "AutoencoderKL", functools.partial(AutoencoderKL, **TINY))
    monkeypatch.setattr(tvae_data, "convert_diffusers_vae",
                        functools.partial(tvae_data.convert_diffusers_vae, **CONVERT))


def test_load_vae_reads_a_bin_through_vaw_vae_path(tiny_vae_files, tmp_path, monkeypatch):
    sd = _diffusers_sd(conv_attention=True)
    path = tmp_path / "diffusion_pytorch_model.bin"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    monkeypatch.setenv("VAW_VAE_PATH", str(path))
    assert tvae_data.find_vae_checkpoint() == str(path)
    model = tvae_data.load_vae(device="cpu")
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    want = tvae_data.convert_diffusers_vae(sd)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    z = torch.from_numpy(_latents(seed=10))
    decode = tvae_data.load_vae_decoder(dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(decode(z).numpy(), _decode_bf16(want, z).numpy())
    encode = tvae_data.load_vae_encoder(device="cpu")
    x = torch.from_numpy(_images(seed=11))
    with torch.no_grad():
        np.testing.assert_array_equal(
            encode(x).numpy(), AutoencoderKL.moments_to_mean_std(model.encode(x)).numpy())


def _decode_bf16(sd, z):
    model = AutoencoderKL(**TINY, compute_dtype=torch.bfloat16)
    model.load_state_dict(sd)
    return model.decode(z)


def test_load_vae_without_a_checkpoint_names_the_path(tmp_path, monkeypatch):
    monkeypatch.delenv("VAW_VAE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    assert tvae_data.find_vae_checkpoint("mse") is None
    with pytest.raises(FileNotFoundError, match="VAW_VAE_PATH"):
        tvae_data.load_vae("mse", device="cpu")


def test_safetensors_needs_its_package(tiny_vae_files, tmp_path, monkeypatch):
    """A .safetensors checkpoint loads where the package imports; without it
    the error names the file and the package."""
    from safetensors.numpy import save_file

    sd = _diffusers_sd()
    path = tmp_path / "vae.safetensors"
    save_file(sd, str(path))
    monkeypatch.setenv("VAW_VAE_PATH", str(path))
    model = tvae_data.load_vae(device="cpu")
    assert torch.equal(model.state_dict()["quant_conv.weight"],
                       torch.from_numpy(sd["quant_conv.weight"]))
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="safetensors package"):
        tvae_data.load_vae(device="cpu")


def test_full_width_bf16_decode_error_is_jaxs():
    """At full width (ch 128, mults (1, 2, 4, 4), 2 res blocks) the bf16
    decode's largest difference from the f32 decode is the JAX package's
    own: the port's is no more than 1.25 times JAX's on the same seeded
    weights (torch's default init, seed 0) and latents (2 x 8x8x4, 64 px
    out), and the two bf16 decodes lie within 0.1 of each other. Both pass
    JAX's 0.1 here but exceed it over more pixels at this depth (the card's
    check in chip_smoke.py scales it with the output's magnitude)."""
    torch.manual_seed(0)
    model = AutoencoderKL()
    b16 = AutoencoderKL(compute_dtype=torch.bfloat16)
    b16.load_state_dict(model.state_dict())
    params = jax_convert({k: v.numpy() for k, v in model.state_dict().items()})
    z = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        t32, t16 = model.decode(z).numpy(), b16.decode(z).numpy()
    j32, j16 = (np.asarray(jax.jit(lambda p, zz, m=m: m.apply({"params": p}, zz,
                                                              method=m.decode))(
        params, jnp.asarray(z.numpy()))) for m in (JaxVAE(), JaxVAE(dtype=jnp.bfloat16)))
    np.testing.assert_allclose(t32, j32, atol=ATOL * np.abs(j32).max(), rtol=0)
    port_err, jax_err = np.abs(t16 - t32).max(), np.abs(j16 - j32).max()
    print(f"full-width bf16 decode, max |bf16 - f32|: port {port_err:.4f}, "
          f"JAX {jax_err:.4f}, |port - JAX| bf16 {np.abs(t16 - j16).max():.4f}, "
          f"max|f32| {np.abs(t32).max():.3f}")
    assert np.isfinite(t16).all() and port_err <= 1.25 * jax_err
    assert np.abs(t16 - j16).max() < BF16_BOUND
