"""Parity of the port's GaussianDiffusion (vaw_torch/core/diffusion.py) and
likelihood losses (vaw_torch/core/losses.py) with vaw_tpu.core on the same
schedules, x_0, t and noise (numpy, fixed seed), with a model function that
both packages compute the same way.

Tolerance: atol 1e-6, rtol 1e-5 (f32 gathers of the same f64 tables and
the same f32 arithmetic; the model function's tanh differs by an ulp); the
discretized log-likelihood 1e-4, since it takes the log of a difference of
two CDF values near 1, which multiplies an ulp of tanh.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaw_torch.core as tc
import vaw_tpu.core as jc
from vaw_tpu.core.losses import approx_standard_normal_cdf as jax_cdf

TOL = dict(atol=1e-6, rtol=1e-5)
MEAN_TYPES = ["PREVIOUS_X", "START_X", "EPSILON", "VELOCITY"]


def _pair(mean_type="EPSILON", weight_type="constant", path="cosine",
          loss_type="MSE", steps=1000, respace=None):
    def build(m):
        base = m.make_schedule(m.get_named_beta_schedule(path, steps))
        sched = base if respace is None else m.respace_schedule(
            base, m.space_timesteps(steps, respace))
        return m.GaussianDiffusion(
            schedule=sched, model_mean_type=m.ModelMeanType[mean_type],
            loss_type=m.LossType[loss_type], weight_type=weight_type,
            p2_k=1.2, p2_gamma=0.5)
    return build(jc), build(tc)


def _data(n=6, seed=0, num_timesteps=1000):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, 4, 4, 3)).astype(np.float32)
    noise = rng.standard_normal((n, 4, 4, 3)).astype(np.float32)
    t = np.concatenate([[0, num_timesteps - 1],
                        rng.integers(0, num_timesteps, n - 2)]).astype(np.int32)
    return x0, noise, t


def _model_jax(x, t, y=None):
    return jnp.tanh(0.5 * x) + (t / 1000.0)[:, None, None, None]


def _model_torch(x, t, y=None):
    return torch.tanh(0.5 * x) + (t / 1000.0)[:, None, None, None]


@pytest.mark.parametrize("path", ["linear", "cosine", "linear_logsnr"])
def test_q_sample_and_posterior(path):
    jd, td = _pair(path=path)
    x0, noise, t = _data()
    want = np.asarray(jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    got = td.q_sample(torch.from_numpy(x0), torch.from_numpy(t).long(),
                      torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    xt = want.copy()
    jm, jv, jl = jd.q_posterior_mean_variance(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))
    tm, tv, tl = td.q_posterior_mean_variance(
        torch.from_numpy(x0), torch.from_numpy(xt), torch.from_numpy(t).long())
    for a, b in ((tm, jm), (tv, jv), (tl, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_compute_target(mean_type):
    jd, td = _pair(mean_type=mean_type)
    x0, noise, t = _data(seed=1)
    want = np.asarray(jd.compute_target(jnp.asarray(x0), jnp.asarray(noise),
                                        jnp.asarray(t)))
    got = td.compute_target(torch.from_numpy(x0), torch.from_numpy(noise),
                            torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mean_type,weight_type", [
    ("EPSILON", "lambda"), ("EPSILON", "constant"), ("EPSILON", "min_snr_5"),
    ("EPSILON", "p2"), ("START_X", "lambda"), ("START_X", "trunc_snr"),
    ("VELOCITY", "lambda"), ("VELOCITY", "min_snr_5"),
    ("PREVIOUS_X", "constant")])
@pytest.mark.parametrize("loss_type", ["MSE", "RESCALED_MSE"])
def test_training_losses(mean_type, weight_type, loss_type):
    jd, td = _pair(mean_type=mean_type, weight_type=weight_type,
                   loss_type=loss_type)
    x0, noise, t = _data(seed=2)
    want = jd.training_losses(_model_jax, jnp.asarray(x0), jnp.asarray(t),
                              jnp.asarray(noise))
    got = td.training_losses(_model_torch, torch.from_numpy(x0),
                             torch.from_numpy(t).long(), torch.from_numpy(noise))
    assert set(got) == {"mse", "loss"}
    for k in ("mse", "loss"):
        assert got[k].shape == (len(t),)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_respaced_model_t_and_sample_t():
    jd, td = _pair(respace="ddim25")
    t = np.arange(td.num_timesteps, dtype=np.int32)
    np.testing.assert_allclose(td._model_t(torch.from_numpy(t).long()).numpy(),
                               np.asarray(jd._model_t(jnp.asarray(t))), **TOL)
    drawn = td.sample_t(torch.Generator().manual_seed(0), 500)
    assert drawn.dtype == torch.int64 and 0 <= drawn.min() and drawn.max() < 25


def test_likelihood_losses_match():
    rng = np.random.default_rng(3)
    x = np.clip(rng.standard_normal((3, 4, 4, 3)), -1, 1).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.0]  # the edge buckets
    means = (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
    # Scales wide enough that cdf_plus - cdf_min stays far above the f32
    # spacing near 1: there the difference cancels, and an ulp of tanh
    # between the two libraries moves its log without bound.
    log_scales = (rng.standard_normal(x.shape) * 0.2 - 0.5).astype(np.float32)
    want = jc.discretized_gaussian_log_likelihood(
        jnp.asarray(x), means=jnp.asarray(means), log_scales=jnp.asarray(log_scales))
    got = tc.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), means=torch.from_numpy(means),
        log_scales=torch.from_numpy(log_scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    kl_want = jc.normal_kl(jnp.asarray(means), jnp.asarray(log_scales), 0.0, 0.0)
    kl_got = tc.normal_kl(torch.from_numpy(means), torch.from_numpy(log_scales), 0.0, 0.0)
    np.testing.assert_allclose(kl_got.numpy(), np.asarray(kl_want), **TOL)
    np.testing.assert_allclose(tc.mean_flat(kl_got).numpy(),
                               np.asarray(jc.mean_flat(kl_want)), **TOL)
    np.testing.assert_allclose(
        tc.approx_standard_normal_cdf(torch.from_numpy(means)).numpy(),
        np.asarray(jax_cdf(jnp.asarray(means))), **TOL)
