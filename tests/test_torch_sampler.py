"""Parity of the port's EDM sampling path (vaw_torch/samplers, core) with the
JAX package's on the same plan, weights, latents and labels.

Tolerances: the host f64 plan equal to 1e-12 (the same numpy code); the
schedule tables bit-equal; the guided 6-step Heun sampler on the tiny DiT,
f32 on both sides with S_churn = 0 (so the sampler is deterministic given
its latents), within 1e-3 of the samples' largest magnitude (eleven model
evaluations of f32 round-off, amplified by the sampler's 1/sigma terms).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.cli.main import build_diffusion
from vaw_torch.core import schedules as ts
from vaw_torch.models.convert import flax_dit_to_torch
from vaw_torch.models.dit import DiT
from vaw_torch.samplers import edm as tedm
from vaw_torch.samplers import guidance as tguid
from vaw_torch.samplers.driver import Sampler
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.core import schedules as js
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.samplers import edm as jedm
from vaw_tpu.samplers import guidance as jguid

TINY = dict(image_size=32, patch_size=2, in_channels=4, hidden_size=128,
            depth=2, num_heads=2, num_classes=10, class_dropout_prob=0.1)


def _tiny_pair(seed=0):
    """The Flax tiny DiT with every param replaced by seeded noise (the
    zero-init adaLN and head included), and the port's DiT on the same
    weights."""
    jmodel = JaxDiT(**TINY)
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, 32, 32, 4)),
                         jnp.zeros((2,)), jnp.zeros((2,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def noise(path, leaf):
        name = getattr(path[-1], "key", "")
        std = (1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if name == "kernel"
               else 0.3 if name == "embedding" else 0.05)
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(noise, params)
    tmodel = DiT(**TINY)
    tmodel.load_state_dict(flax_dit_to_torch(params), strict=True)
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("name", ["linear", "cosine", "linear_logsnr"])
def test_sigma_ladder_and_betas_bit_equal(name):
    np.testing.assert_array_equal(ts.edm_sigma_ladder(name), js.edm_sigma_ladder(name))
    np.testing.assert_array_equal(ts.get_named_beta_schedule(name, 1000),
                                  js.get_named_beta_schedule(name, 1000))


def test_respaced_schedule_bit_equal():
    for counts in ("ddim25", "10,15,5"):
        assert ts.space_timesteps(1000, counts) == js.space_timesteps(1000, counts)
    betas = js.get_named_beta_schedule("cosine", 1000)
    want = js.respace_schedule(js.make_schedule(betas), js.space_timesteps(1000, "ddim50"))
    got = ts.respace_schedule(ts.make_schedule(betas), ts.space_timesteps(1000, "ddim50"))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))


@pytest.mark.parametrize("pred_type", ["EPSILON", "VELOCITY"])
@pytest.mark.parametrize("solver", ["euler", "heun"])
@pytest.mark.parametrize("discretization", ["vp", "ve", "iddpm", "edm"])
def test_build_edm_plan_matches(discretization, solver, pred_type):
    kw = dict(num_steps=18, solver=solver, discretization=discretization,
              pred_type=pred_type, S_churn=10.0)
    want, got = jedm.build_edm_plan(**kw), tedm.build_edm_plan(**kw)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w, atol=1e-12, rtol=1e-12)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("t,g,interval", [
    (500.0, 1.5, (-1.0, -1.0)), (500.0, 1.0, (-1.0, -1.0)),
    (100.0, 4.0, (200.0, 800.0)), (200.0, 4.0, (200.0, 800.0)),
    (800.0, 4.0, (200.0, 800.0)), (300.0, 2.0, (800.0, 200.0)),
])
def test_cfg_scale_for_time_matches(t, g, interval):
    assert (tguid.cfg_scale_for_time(t, g, interval)
            == jguid.cfg_scale_for_time(t, g, interval))


def test_guided_heun_sampler_matches_jax():
    jmodel, params, tmodel = _tiny_pair()
    rng = np.random.default_rng(11)
    latents = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    plan = jedm.build_edm_plan(num_steps=6, solver="heun", discretization="edm")
    g_steps = np.full(6, 1.5)

    def jax_model(x, t, y=None):
        return jmodel.apply({"params": params}, x, t, y)

    want = jedm.ablation_sampler(
        jguid.IntervalCFG(jax_model, 10, 1.5), jax.random.key(0),
        jnp.asarray(latents), plan, class_labels=jnp.asarray(labels),
        guidance_scales=g_steps, img_channels=4)
    got = tedm.ablation_sampler(
        tguid.IntervalCFG(lambda x, t, y=None: tmodel(x, t, y), 10, 1.5), None,
        torch.from_numpy(latents), tedm.build_edm_plan(num_steps=6),
        class_labels=torch.from_numpy(labels).long(), guidance_scales=g_steps,
        img_channels=4)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def test_sampler_shapes_dtype_and_determinism():
    _, _, tmodel = _tiny_pair(seed=3)
    cfg = TrainConfig(model="DiT-S", image_size=32, in_chans=4, num_classes=10,
                      class_cond=True, sample_steps=2, guidance_scale=1.5,
                      amp=False)
    sampler = Sampler(cfg, lambda x, t, y=None: tmodel(x, t, y), device="cpu")
    runs = [sampler.sample(torch.Generator().manual_seed(7), 3, 2, 32, 10)
            for _ in range(2)]
    (s0, l0), (s1, l1) = runs
    assert s0.shape == (3, 32, 32, 4) and s0.dtype == np.uint8
    assert l0.shape == (3,) and ((0 <= l0) & (l0 < 10)).all()
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(l0, l1)
    other, _ = sampler.sample(torch.Generator().manual_seed(8), 3, 2, 32, 10)
    assert not np.array_equal(s0, other)


@pytest.mark.parametrize("mode,solver", [("diffusion", "ddim")])
def test_sampler_refuses_unported_paths(mode, solver):
    """The DDIM path, refused before it was ported, now samples: the
    driver's batch is the respaced process's DDIM loop under CFG on the
    same generator draws (labels, then x_T), cast to uint8. What the
    sampler still refuses: a DDIM sampler without its process, and
    classifier guidance off the DDIM path."""
    _, _, tmodel = _tiny_pair(seed=5)
    cfg = TrainConfig(model_mode=mode, solver=solver, model="DiT-S", image_size=32,
                      in_chans=4, num_classes=10, class_cond=True, sample_steps=4,
                      diffusion_steps=50, path_type="cosine", guidance_scale=1.5,
                      amp=False)

    def model_fn(x, t, y=None):
        return tmodel(x, t, y)

    with pytest.raises(ValueError, match="needs its process"):
        Sampler(cfg, model_fn, device="cpu")
    diffusion = build_diffusion(cfg, use_ddim=True)
    assert diffusion.num_timesteps == 4
    sampler = Sampler(cfg, model_fn, diffusion=diffusion, device="cpu")
    samples, labels = sampler.sample(torch.Generator().manual_seed(1), 2, 2, 32, 10)
    gen = torch.Generator().manual_seed(1)
    y = torch.randint(0, 10, (2,), generator=gen)
    with torch.no_grad():
        x = diffusion.ddim_sample_loop(tguid.IntervalCFG(model_fn, 10, 1.5),
                                       (2, 32, 32, 4), generator=gen,
                                       model_kwargs={"y": y}, device="cpu")
    np.testing.assert_array_equal(labels, y.numpy())
    np.testing.assert_array_equal(
        samples, torch.clamp((x + 1) * 127.5, 0, 255).to(torch.uint8).numpy())
    with pytest.raises(ValueError, match="requires --model_mode diffusion --solver ddim"):
        Sampler(dataclasses.replace(cfg, solver="heun"), model_fn,
                classifier_fn=lambda x, t: x, device="cpu")
