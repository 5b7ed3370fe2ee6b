"""Parity of the port's flow matching (vaw_torch/core/flow.py) with the JAX
package's (vaw_tpu/core/flow.py): interpolants, conversions and targets for
every path and mean type, the weighted training loss, the ODE samplers
(Euler, Heun and the adaptive dopri5, whose accepted and rejected steps must
be the same), the SDE samplers with the JAX sampler's own noise fed through
``noise_fn``, the REPA align term, and the refusals at singular endpoints.

The samplers run a toy drift both packages compute the same way (a fixed
nonlinear map of x and t with seeded numpy weights), 3x4x4x2 states.
Tolerances: tables and losses atol 1e-6, rtol 1e-5
(tests/test_torch_diffusion.py); whole samplers after N steps atol 1e-4.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.core import FlowMatching, ModelMeanType, interpolant
from vaw_tpu.core import FlowMatching as JaxFlow
from vaw_tpu.core import ModelMeanType as JaxMeanType
from vaw_tpu.core import interpolant as jax_interpolant

TOL = dict(atol=1e-6, rtol=1e-5)
SAMPLER_ATOL = 1e-4
PATHS = ("linear", "cosine", "linear_logsnr")
SHAPE = (3, 4, 4, 2)


def _pair(mean_type="VECTOR", **kw):
    return (JaxFlow(model_mean_type=JaxMeanType[mean_type], **kw),
            FlowMatching(model_mean_type=ModelMeanType[mean_type], **kw))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    out = rng.standard_normal(SHAPE).astype(np.float32)
    t = rng.uniform(0.05, 0.95, SHAPE[0]).astype(np.float32)
    return x0, noise, out, t


@pytest.mark.parametrize("path", PATHS)
def test_interpolants_match(path):
    t = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    want = jax_interpolant(path, jnp.asarray(t))
    got = interpolant(path, torch.from_numpy(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mean_type", ["START_X", "EPSILON", "VELOCITY", "VECTOR",
                                       "SCORE"])
def test_conversions_and_targets_match(path, mean_type):
    jf, tf = _pair(mean_type, path_type=path)
    x0, noise, out, t = _data()
    te = t.reshape(-1, 1, 1, 1)
    to = torch.from_numpy
    if mean_type != "SCORE":
        np.testing.assert_allclose(
            tf.convert_model_output_to_vector(to(out), to(x0), to(te)).numpy(),
            np.asarray(jf.convert_model_output_to_vector(out, x0, te)), **TOL)
    np.testing.assert_allclose(
        tf.convert_model_output_to_score(to(out), to(x0), to(te)).numpy(),
        np.asarray(jf.convert_model_output_to_score(out, x0, te)), **TOL)
    np.testing.assert_allclose(tf.compute_target(to(x0), to(noise), to(t)).numpy(),
                               np.asarray(jf.compute_target(x0, noise, t)), **TOL)
    np.testing.assert_allclose(tf.q_sample(to(x0), to(noise), to(t)).numpy(),
                               np.asarray(jf.q_sample(x0, noise, t)), **TOL)


def _toy(seed=7):
    """A fixed drift both packages evaluate alike: tanh(x W + b t), W a
    per-channel 2x2 mix."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((2, 2)) * 0.8).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)

    def jax_fn(x, t, **kw):
        return jnp.tanh(jnp.einsum("nhwc,cd->nhwd", x, w)
                        + t.reshape(-1, 1, 1, 1) * b)

    tw, tb = torch.from_numpy(w), torch.from_numpy(b)

    def torch_fn(x, t, **kw):
        return torch.tanh(torch.einsum("nhwc,cd->nhwd", x, tw)
                          + t.reshape(-1, 1, 1, 1) * tb)

    return jax_fn, torch_fn


@pytest.mark.parametrize("path", ["linear", "cosine"])
@pytest.mark.parametrize("weight_type", ["lambda", "constant"])
@pytest.mark.parametrize("mean_type", ["VECTOR", "VELOCITY"])
def test_training_losses_match(path, weight_type, mean_type):
    jf, tf = _pair(mean_type, path_type=path, weight_type=weight_type)
    x0, noise, _, t = _data(seed=1)
    jax_fn, torch_fn = _toy()
    want = jf.training_losses(jax_fn, jnp.asarray(x0), jnp.asarray(t),
                              jnp.asarray(noise))
    got = tf.training_losses(torch_fn, torch.from_numpy(x0), torch.from_numpy(t),
                             torch.from_numpy(noise))
    assert set(got) == set(want) == {"mse", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_sample_t_draws_from_the_generator():
    _, uni = _pair(time_dist=("uniform",))
    _, logn = _pair(time_dist=("lognorm", 0.5, 1.0))
    a = uni.sample_t(torch.Generator().manual_seed(3), 4000)
    b = uni.sample_t(torch.Generator().manual_seed(3), 4000)
    assert torch.equal(a, b) and 0 <= a.min() and a.max() < 1
    assert abs(a.mean().item() - 0.5) < 0.02
    z = logn.sample_t(torch.Generator().manual_seed(3), 4000)
    logit = torch.log(z / (1 - z))
    assert abs(logit.mean().item() - 0.5) < 0.06 and abs(logit.std().item() - 1) < 0.06


@pytest.mark.parametrize("solver", ["euler", "heun"])
@pytest.mark.parametrize("path", ["linear", "cosine"])
def test_ode_fixed_step_matches(solver, path):
    jf, tf = _pair("VECTOR", path_type=path)
    jax_fn, torch_fn = _toy()
    noise = _data(seed=2)[1]
    want = jf.ode_sample(jax_fn, jnp.asarray(noise), num_steps=12, solver=solver)
    got = tf.ode_sample(torch_fn, torch.from_numpy(noise), num_steps=12, solver=solver)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLER_ATOL, rtol=0)


def _recording(fn, times):
    def wrapped(x, t, **kw):
        times.append(float(np.asarray(t)[0]))
        return fn(x, t, **kw)
    return wrapped


def _stiff():
    """A stiff drift that makes dopri5 reject steps: v = k (x - tanh(x W)),
    which contracts x as t runs from 1 to 0, fast where k is large (t near
    1)."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((2, 2)).astype(np.float32)

    def jax_fn(x, t, **kw):
        k = 2.0 + 60.0 * t.reshape(-1, 1, 1, 1)
        return k * (x - jnp.tanh(jnp.einsum("nhwc,cd->nhwd", x, w)))

    tw = torch.from_numpy(w)

    def torch_fn(x, t, **kw):
        k = 2.0 + 60.0 * t.reshape(-1, 1, 1, 1)
        return k * (x - torch.tanh(torch.einsum("nhwc,cd->nhwd", x, tw)))

    return jax_fn, torch_fn


def _attempts(times):
    """(t, h, accepted) of each attempt of the adaptive loop, read from the
    drift's evaluation times: the first call is at t = 1, then six a
    attempt at t - h c_i with c = 1/5, 3/10, 4/5, 8/9, 1, 1. An attempt is
    accepted when the next one starts from t - h (the last when the loop
    ended at t = 0)."""
    stages = np.asarray(times[1:]).reshape(-1, 6)
    h = (stages[:, 0] - stages[:, 1]) / 0.1
    t = stages[:, 0] + 0.2 * h
    accepted = [bool(t[i + 1] < t[i] - h[i] / 2) for i in range(len(t) - 1)]
    return t, h, accepted + [bool(abs(t[-1] - h[-1]) < 1e-5)]


@pytest.mark.parametrize("drift", ["toy", "stiff"])
def test_dopri5_accepts_and_rejects_the_same_steps(drift):
    """Both loops make the same sequence of accepted and rejected attempts,
    read from the drift's evaluation times (the JAX loop runs with jit off,
    so its drift sees concrete times). The step sizes agree to the error
    estimate's rounding: x5 - x4 is a difference of two f32 sums, which the
    two libraries round apart, and the controller takes its fifth root."""
    jf, tf = _pair("VECTOR", path_type="linear")
    jax_fn, torch_fn = _toy() if drift == "toy" else _stiff()
    noise = _data(seed=3)[1]
    jax_times, torch_times = [], []
    with jax.disable_jit():
        want = jf.ode_sample(_recording(jax_fn, jax_times), jnp.asarray(noise),
                             solver="dopri5", rtol=1e-3, atol=1e-6)
    info = {}
    got = tf.ode_sample(_recording(torch_fn, torch_times), torch.from_numpy(noise),
                        solver="dopri5", rtol=1e-3, atol=1e-6, info=info)
    assert len(torch_times) == len(jax_times)
    t_got, h_got, acc_got = _attempts(torch_times)
    t_want, h_want, acc_want = _attempts(jax_times)
    assert acc_got == acc_want
    assert acc_got.count(True) == info["accepted"] and acc_got.count(False) == info["rejected"]
    np.testing.assert_allclose(h_got, h_want, rtol=2e-2, atol=0)
    np.testing.assert_allclose(t_got, t_want, atol=2e-2, rtol=0)
    assert info["t"] <= 1e-6
    if drift == "stiff":
        assert info["rejected"] > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLER_ATOL, rtol=0)


def test_dopri5_warns_when_unconverged(capfd):
    jf, tf = _pair("VECTOR", path_type="linear")
    jax_fn, torch_fn = _stiff()
    noise = _data(seed=4)[1]
    with jax.disable_jit():
        want = jf._dopri5(jax_fn, jnp.asarray(noise), {}, 1e-4, 1e-6, max_steps=5)
    assert "UNCONVERGED" in capfd.readouterr().out
    info = {}
    with pytest.warns(RuntimeWarning, match="UNCONVERGED"):
        got = tf._dopri5(torch_fn, torch.from_numpy(noise), {}, 1e-4, 1e-6,
                         max_steps=5, info=info)
    assert info["accepted"] + info["rejected"] == 5 and info["t"] > 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLER_ATOL, rtol=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tf._dopri5(torch_fn, torch.from_numpy(noise), {}, 1e-3, 1e-6)


@pytest.mark.parametrize("solver", ["euler", "heun"])
@pytest.mark.parametrize("mean_type,path", [("VECTOR", "linear"), ("VELOCITY", "cosine"),
                                            ("START_X", "linear")])
def test_sde_matches_with_jax_noise(solver, mean_type, path):
    jf, tf = _pair(mean_type, path_type=path)
    jax_fn, torch_fn = _toy()
    noise = _data(seed=5)[1]
    rng = jax.random.key(11)
    steps = 10
    want = jf.sde_sample(jax_fn, rng, jnp.asarray(noise), num_steps=steps,
                         solver=solver)
    # The JAX sampler's step-i draw (vaw_tpu/core/flow.py:365).
    eps = [np.array(jax.random.normal(jax.random.fold_in(rng, i), noise.shape,
                                        jnp.float32)) for i in range(steps - 1)]
    calls = []

    def noise_fn(i, shape):
        calls.append(i)
        return torch.from_numpy(eps[i])

    got = tf.sde_sample(torch_fn, None, torch.from_numpy(noise), num_steps=steps,
                        solver=solver, noise_fn=noise_fn)
    assert calls == list(range(steps - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLER_ATOL, rtol=0)


def test_sample_dispatches_and_draws_from_the_generator():
    _, sde = _pair("VECTOR", sampler_type="sde")
    _, ode = _pair("VECTOR", sampler_type="ode")
    _, torch_fn = _toy()
    noise = torch.from_numpy(_data(seed=6)[1])
    a = sde.sample(torch_fn, torch.Generator().manual_seed(1), noise, num_steps=6)
    b = sde.sample(torch_fn, torch.Generator().manual_seed(1), noise, num_steps=6)
    c = sde.sample(torch_fn, torch.Generator().manual_seed(2), noise, num_steps=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(ode.sample(torch_fn, None, noise, num_steps=6),
                               ode.ode_sample(torch_fn, noise, num_steps=6))


@pytest.mark.parametrize("mean_type,ode", [("EPSILON", True), ("EPSILON", False),
                                           ("START_X", True)])
def test_singular_endpoints_are_refused(mean_type, ode):
    jf, tf = _pair(mean_type)
    _, torch_fn = _toy()
    noise = torch.from_numpy(_data()[1])
    for flow in (jf, tf):
        with pytest.raises(ValueError, match="singular"):
            flow._check_sampleable(ode=ode)
    with pytest.raises(ValueError, match="singular"):
        if ode:
            tf.ode_sample(torch_fn, noise, num_steps=4)
        else:
            tf.sde_sample(torch_fn, None, noise, num_steps=4)


@pytest.mark.parametrize("align_type", ["cosine", "mse", "mse_l2", "nt_xent"])
def test_align_term_matches_jax(align_type):
    """learn_align (vaw_tpu/core/flow.py:186-189): the model returns (out,
    zs), the loss adds gamma times the align loss between the teacher's
    features and zs; gamma 0 is refused."""
    jf, tf = _pair(learn_align=True, gamma=0.5, align_type=align_type)
    x0, noise, _, t = _data(seed=3)
    jax_fn, torch_fn = _toy()
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((SHAPE[0], 5, 6)).astype(np.float32)
    zs = rng.standard_normal((SHAPE[0], 5, 6)).astype(np.float32)
    want = jf.training_losses(lambda x, tt, **kw: (jax_fn(x, tt), jnp.asarray(zs)),
                              jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                              features=jnp.asarray(feats))
    to = torch.from_numpy
    got = tf.training_losses(lambda x, tt, **kw: (torch_fn(x, tt), to(zs)), to(x0),
                             to(t), to(noise), features=to(feats))
    assert set(got) == set(want) == {"mse", "align", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    _, tf0 = _pair(learn_align=True, gamma=0.0)
    with pytest.raises(ValueError, match="gamma must be > 0"):
        tf0.training_losses(lambda x, tt, **kw: (torch_fn(x, tt), to(zs)), to(x0),
                            to(t), to(noise), features=to(feats))
