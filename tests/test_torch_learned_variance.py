"""Parity of the port's learned variance and KL losses (ROADMAP A3;
vaw_torch/core/diffusion.py) with the JAX package's
(vaw_tpu/core/diffusion.py:105-557): q_mean_variance, the x_0 and eps
predictions, p_mean_variance for every variance and mean type, the
variational-bound term, the KL and RESCALED_KL losses, the learned-range
MSE and RESCALED_MSE losses with their vb term (whose gradient must reach
the variance channels only), the prior term and calc_bpd_loop at 20
diffusion steps with the JAX loop's own noise fed through ``noise_fn``.

The model is a function both packages compute alike (tanh of the input
and t), with 2C output channels for the learned variance types; 6 x 4x4x3
inputs spanning t = 0 and t = T-1. Tolerance: atol 1e-6, rtol 1e-5
(tests/test_torch_diffusion.py); the terms that go through the discretized
Gaussian log-likelihood, the decoder NLL at t = 0, 1e-4, since it takes the
log of a difference of two CDF values near 1 (that file's bound too).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaw_torch.core as tc
import vaw_tpu.core as jc

TOL = dict(atol=1e-6, rtol=1e-5)
NLL_TOL = dict(atol=1e-4, rtol=1e-4)
MEAN_TYPES = ["PREVIOUS_X", "START_X", "EPSILON", "VELOCITY"]
VAR_TYPES = ["LEARNED", "LEARNED_RANGE", "FIXED_LARGE", "FIXED_SMALL"]


def _pair(mean_type="EPSILON", var_type="LEARNED_RANGE", loss_type="MSE",
          steps=1000, path="cosine", weight_type="constant"):
    def build(m):
        return m.GaussianDiffusion(
            schedule=m.make_schedule(m.get_named_beta_schedule(path, steps)),
            model_mean_type=m.ModelMeanType[mean_type],
            model_var_type=m.ModelVarType[var_type],
            loss_type=m.LossType[loss_type], weight_type=weight_type)
    return build(jc), build(tc)


def _data(n=6, seed=0, steps=1000):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.standard_normal((n, 4, 4, 3)) * 0.5, -1, 1).astype(np.float32)
    noise = rng.standard_normal((n, 4, 4, 3)).astype(np.float32)
    t = np.concatenate([[0, steps - 1], rng.integers(0, steps, n - 2)]).astype(np.int32)
    return x0, noise, t


def _models(learned: bool):
    """out = tanh(x / 2) + t / 1000, and with a learned variance a second
    half tanh(x) * 0.9 (in (-1, 1): a LEARNED_RANGE fraction)."""
    def jax_fn(x, t, **kw):
        mean = jnp.tanh(0.5 * x) + (t / 1000.0)[:, None, None, None]
        return jnp.concatenate([mean, 0.9 * jnp.tanh(x)], -1) if learned else mean

    def torch_fn(x, t, **kw):
        mean = torch.tanh(0.5 * x) + (t / 1000.0)[:, None, None, None]
        return torch.cat([mean, 0.9 * torch.tanh(x)], -1) if learned else mean

    return jax_fn, torch_fn


def _t(a):
    return torch.from_numpy(np.array(a))


def test_q_mean_variance_and_predictions():
    jd, td = _pair()
    x0, noise, t = _data()
    xt = np.asarray(jd.q_sample(x0, t, noise))
    tt = _t(t).long()
    for g, w in zip(td.q_mean_variance(_t(x0), tt), jd.q_mean_variance(x0, t)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for name in ("_predict_xstart_from_eps", "_predict_xstart_from_v",
                 "_predict_xstart_from_xprev", "_predict_eps_from_xstart"):
        got = getattr(td, name)(_t(xt), tt, _t(noise)).numpy()
        want = np.asarray(getattr(jd, name)(xt, t, noise))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_p_mean_variance_matches(var_type, mean_type):
    jd, td = _pair(mean_type, var_type)
    x0, noise, t = _data(seed=1)
    xt = np.asarray(jd.q_sample(x0, t, noise))
    jax_fn, torch_fn = _models(var_type.startswith("LEARNED"))
    for clip in (True, False):
        want = jd.p_mean_variance(jax_fn, jnp.asarray(xt), jnp.asarray(t),
                                  clip_denoised=clip)
        got = td.p_mean_variance(torch_fn, _t(xt), _t(t).long(), clip_denoised=clip)
        assert set(got) == set(want)
        for k in want:
            w = np.broadcast_to(np.asarray(want[k]), got[k].shape)
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{k} clip={clip}")


@pytest.mark.parametrize("loss_type", ["KL", "RESCALED_KL"])
@pytest.mark.parametrize("var_type", ["LEARNED_RANGE", "FIXED_SMALL"])
def test_kl_losses_match(loss_type, var_type):
    jd, td = _pair("EPSILON", var_type, loss_type)
    x0, noise, t = _data(seed=2)
    jax_fn, torch_fn = _models(var_type.startswith("LEARNED"))
    want = jd.training_losses(jax_fn, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = td.training_losses(torch_fn, _t(x0), _t(t).long(), _t(noise))
    assert set(got) == set(want) == {"loss"}
    # t = 0 (index 0) is the decoder NLL; the rest are KL terms.
    np.testing.assert_allclose(got["loss"].numpy()[1:], np.asarray(want["loss"])[1:], **TOL)
    scale = jd.num_timesteps if loss_type == "RESCALED_KL" else 1
    np.testing.assert_allclose(got["loss"].numpy()[:1] / scale,
                               np.asarray(want["loss"])[:1] / scale, **NLL_TOL)


@pytest.mark.parametrize("loss_type", ["MSE", "RESCALED_MSE"])
@pytest.mark.parametrize("var_type", ["LEARNED_RANGE", "LEARNED"])
@pytest.mark.parametrize("weight_type", ["constant", "lambda"])
def test_learned_variance_mse_with_vb_matches(loss_type, var_type, weight_type):
    jd, td = _pair("EPSILON", var_type, loss_type, weight_type=weight_type)
    x0, noise, t = _data(seed=3)
    jax_fn, torch_fn = _models(True)
    want = jd.training_losses(jax_fn, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = td.training_losses(torch_fn, _t(x0), _t(t).long(), _t(noise))
    assert set(got) == set(want) == {"mse", "vb", "loss"}
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), **TOL)
    for k in ("vb", "loss"):
        np.testing.assert_allclose(got[k].numpy()[1:], np.asarray(want[k])[1:], **TOL)
        np.testing.assert_allclose(got[k].numpy()[:1], np.asarray(want[k])[:1], **NLL_TOL)


def test_vb_term_moves_only_the_variance_channels():
    """The vb term reaches the model output through its variance half only
    (the mean half is detached, as the JAX loss's stop_gradient); its
    gradient there equals JAX's."""
    jd, td = _pair("EPSILON", "LEARNED_RANGE")
    x0, noise, t = _data(seed=4)
    rng = np.random.default_rng(5)
    out = rng.uniform(-0.9, 0.9, (6, 4, 4, 6)).astype(np.float32)
    out_t = _t(out).clone().requires_grad_(True)
    terms = td.training_losses(lambda x, tt, **kw: out_t, _t(x0), _t(t).long(), _t(noise))
    (grad_vb,) = torch.autograd.grad(terms["vb"].sum(), out_t, retain_graph=True)
    assert torch.all(grad_vb[..., :3] == 0) and torch.any(grad_vb[..., 3:] != 0)
    (grad_mse,) = torch.autograd.grad(terms["mse"].sum(), out_t)
    assert torch.all(grad_mse[..., 3:] == 0) and torch.any(grad_mse[..., :3] != 0)

    def jax_vb(o):
        return jd.training_losses(lambda *a, **k: o, jnp.asarray(x0), jnp.asarray(t),
                                  jnp.asarray(noise))["vb"].sum()

    want = np.asarray(jax.grad(jax_vb)(jnp.asarray(out)))
    np.testing.assert_allclose(grad_vb.numpy()[1:], want[1:], atol=1e-5, rtol=1e-4)


def test_calc_bpd_loop_matches_at_20_steps():
    steps = 20
    jd, td = _pair("EPSILON", "LEARNED_RANGE", steps=steps, path="cosine")
    x0, _, _ = _data(n=3, seed=6, steps=steps)
    jax_fn, torch_fn = _models(True)
    rng = jax.random.key(3)
    want = jd.calc_bpd_loop(jax_fn, rng, jnp.asarray(x0), clip_denoised=True)
    # The JAX loop's draw at timestep i (vaw_tpu/core/diffusion.py:533).
    eps = {i: np.array(jax.random.normal(jax.random.fold_in(rng, i), x0.shape))
           for i in range(steps)}
    order = []

    def noise_fn(i, shape):
        order.append(i)
        return torch.from_numpy(eps[i])

    got = td.calc_bpd_loop(torch_fn, None, _t(x0), clip_denoised=True, noise_fn=noise_fn)
    assert order == list(range(steps - 1, -1, -1))
    assert set(got) == set(want)
    assert all(np.isfinite(np.asarray(v)).all() for v in want.values())
    for k in ("prior_bpd", "xstart_mse", "mse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert got["vb"].shape == (3, steps)
    np.testing.assert_allclose(got["vb"].numpy()[:, :-1], np.asarray(want["vb"])[:, :-1],
                               atol=1e-5, rtol=1e-5)
    # The last column is t = 0, the decoder NLL.
    np.testing.assert_allclose(got["vb"].numpy()[:, -1], np.asarray(want["vb"])[:, -1],
                               **NLL_TOL)
    np.testing.assert_allclose(got["total_bpd"].numpy(), np.asarray(want["total_bpd"]),
                               **NLL_TOL)
    np.testing.assert_allclose(td._prior_bpd(_t(x0)).numpy(),
                               np.asarray(jd._prior_bpd(jnp.asarray(x0))), **TOL)


def test_learned_variance_needs_2c_channels():
    _, td = _pair("EPSILON", "LEARNED_RANGE")
    x0, noise, t = _data()
    _, torch_fn = _models(False)
    with pytest.raises(ValueError, match="6 output channels"):
        td.training_losses(torch_fn, _t(x0), _t(t).long(), _t(noise))
