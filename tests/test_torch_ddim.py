"""Parity of the port's sampling steps and loops (vaw_torch/core/
diffusion.py: condition_mean, condition_score, p_sample, ddim_sample,
ddim_reverse_sample, p_sample_loop, ddim_sample_loop) and of classifier
guidance (vaw_torch/samplers/guidance.py: classifier_cond_fn) with the JAX
package's, on the same schedules, models and noise.

The noise is JAX's: a loop's initial noise from split(rng)[1] and step i's
from fold_in(split(rng)[0], i), fed to the port's loops through `noise`
and `noise_fn`, and to single steps as a tensor. The model is a smooth
closed form of (x, t), the same in numpy terms on both sides, with a
learned-variance half where the variance type asks for one; the classifier
is a small EncoderUNet (attention pool) carried across with
flax_encoder_unet_to_torch.

Tolerances: one step within 1e-5 of max|x| (f32, one model call); a loop
of 10-20 steps within 1e-4; a gradient of the classifier within 1e-4 of
its max (f32 through some 15 layers forward and backward).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.core import GaussianDiffusion as TorchDiffusion
from vaw_torch.core import ModelMeanType as TMean
from vaw_torch.core import ModelVarType as TVar
from vaw_torch.models import unet as port_unet
from vaw_torch.models.convert import flax_encoder_unet_to_torch
from vaw_torch.samplers.guidance import classifier_cond_fn as t_cond_fn
from vaw_tpu.core import GaussianDiffusion as JaxDiffusion
from vaw_tpu.core import ModelMeanType as JMean
from vaw_tpu.core import ModelVarType as JVar
from vaw_tpu.core import (
    get_named_beta_schedule,
    make_schedule,
    respace_schedule,
    space_timesteps,
)
from vaw_tpu.models import unet as jax_unet
from vaw_tpu.samplers.guidance import classifier_cond_fn as j_cond_fn

SHAPE = (2, 8, 8, 3)
STEP_RTOL, LOOP_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-4


def _pair(steps=20, respace=None, mean="EPSILON", var="FIXED_LARGE"):
    sched = make_schedule(get_named_beta_schedule("cosine", steps))
    if respace:
        sched = respace_schedule(sched, space_timesteps(steps, respace))
    jd = JaxDiffusion(schedule=sched, model_mean_type=JMean[mean], model_var_type=JVar[var])
    td = TorchDiffusion(schedule=sched, model_mean_type=TMean[mean],
                        model_var_type=TVar[var])
    return jd, td


def _model(learned: bool):
    """out = tanh(0.7 x + 0.3 t/1000 + 0.1 y) (+ a [-1, 1] variance half)."""
    def jfn(x, t, y=None):
        a = x * 0.7 + (t[:, None, None, None] / 1000.0) * 0.3
        if y is not None:
            a = a + 0.1 * y[:, None, None, None].astype(jnp.float32)
        out = jnp.tanh(a)
        return jnp.concatenate([out, jnp.tanh(0.5 * x - 0.2)], -1) if learned else out

    def tfn(x, t, y=None):
        a = x * 0.7 + (t[:, None, None, None] / 1000.0) * 0.3
        if y is not None:
            a = a + 0.1 * y[:, None, None, None].float()
        out = torch.tanh(a)
        return torch.cat([out, torch.tanh(0.5 * x - 0.2)], -1) if learned else out

    return jfn, tfn


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rtol, f"relative error {err} > {rtol}"


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def _t(i):
    return np.full((SHAPE[0],), i, np.int32)


def _guide():
    """A closed-form cond_fn, the same on both sides: 0.1 tanh(x) + t/1e4."""
    def j(x, t, y=None):
        return 0.1 * jnp.tanh(x) + (t / 1e4)[:, None, None, None]

    def tt(x, t, y=None):
        return 0.1 * torch.tanh(x) + (t / 1e4)[:, None, None, None]

    return j, tt


CASES = [("EPSILON", "FIXED_LARGE"), ("EPSILON", "FIXED_SMALL"),
         ("START_X", "LEARNED_RANGE"), ("VELOCITY", "LEARNED"),
         ("PREVIOUS_X", "FIXED_SMALL")]


@pytest.mark.parametrize("mean,var", CASES)
@pytest.mark.parametrize("guided", [False, True])
def test_p_sample_step(mean, var, guided):
    jd, td = _pair(mean=mean, var=var)
    jfn, tfn = _model(var.startswith("LEARNED"))
    jg, tg = _guide() if guided else (None, None)
    x = _x(0)
    for i in (11, 0):
        key = jax.random.key(i)
        want = jd.p_sample(jfn, key, jnp.asarray(x), jnp.asarray(_t(i)), cond_fn=jg)
        jnoise = jax.random.normal(key, SHAPE, jnp.float32)
        got = td.p_sample(tfn, torch.tensor(np.asarray(jnoise)), torch.from_numpy(x),
                          torch.from_numpy(_t(i)).long(), cond_fn=tg)
        _close(got["sample"], want["sample"], STEP_RTOL)
        _close(got["pred_xstart"], want["pred_xstart"], STEP_RTOL)


@pytest.mark.parametrize("mean", ["EPSILON", "VELOCITY", "START_X"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("guided", [False, True])
def test_ddim_step(mean, eta, guided):
    jd, td = _pair(respace="ddim10", mean=mean)
    jfn, tfn = _model(False)
    jg, tg = _guide() if guided else (None, None)
    x = _x(2)
    for i in (7, 0):
        key = jax.random.key(10 + i)
        want = jd.ddim_sample(jfn, key, jnp.asarray(x), jnp.asarray(_t(i)), cond_fn=jg,
                              eta=eta)
        jnoise = jax.random.normal(key, SHAPE, jnp.float32)
        got = td.ddim_sample(tfn, torch.tensor(np.asarray(jnoise)), torch.from_numpy(x),
                             torch.from_numpy(_t(i)).long(), cond_fn=tg, eta=eta)
        _close(got["sample"], want["sample"], STEP_RTOL)


def test_ddim_reverse_step_and_condition_helpers():
    jd, td = _pair(respace="ddim10")
    jfn, tfn = _model(False)
    jg, tg = _guide()
    x = _x(3)
    t = _t(4)
    want = jd.ddim_reverse_sample(jfn, jnp.asarray(x), jnp.asarray(t))
    got = td.ddim_reverse_sample(tfn, torch.from_numpy(x), torch.from_numpy(t).long())
    _close(got["sample"], want["sample"], STEP_RTOL)
    with pytest.raises(ValueError, match="eta"):
        td.ddim_reverse_sample(tfn, torch.from_numpy(x), torch.from_numpy(t).long(), eta=0.5)
    jout = jd.p_mean_variance(jfn, jnp.asarray(x), jnp.asarray(t))
    tout = td.p_mean_variance(tfn, torch.from_numpy(x), torch.from_numpy(t).long())
    _close(td.condition_mean(tg, tout, torch.from_numpy(x), torch.from_numpy(t).long()),
           jd.condition_mean(jg, jout, jnp.asarray(x), jnp.asarray(t)), STEP_RTOL)
    tscore = td.condition_score(tg, tout, torch.from_numpy(x), torch.from_numpy(t).long())
    jscore = jd.condition_score(jg, jout, jnp.asarray(x), jnp.asarray(t))
    for k in ("mean", "pred_xstart"):
        _close(tscore[k], jscore[k], STEP_RTOL)


def _jax_noise(rng, n_steps):
    """JAX's loop noise: x_T from split(rng)[1], step i from
    fold_in(split(rng)[0], i)."""
    step_rng, init_rng = jax.random.split(rng)
    init = np.array(jax.random.normal(init_rng, SHAPE, jnp.float32))
    steps = {i: np.array(jax.random.normal(jax.random.fold_in(step_rng, i), SHAPE,
                                             jnp.float32)) for i in range(n_steps)}
    return init, steps


def _feed(steps):
    return lambda i, shape: torch.from_numpy(steps[i])


@pytest.mark.parametrize("var", ["FIXED_LARGE", "LEARNED_RANGE"])
@pytest.mark.parametrize("guided", [False, True])
def test_p_sample_loop(var, guided):
    jd, td = _pair(steps=20, var=var)
    jfn, tfn = _model(var == "LEARNED_RANGE")
    jg, tg = _guide() if guided else (None, None)
    y = np.array([1, 2], np.int32)
    rng = jax.random.key(5)
    want = jd.p_sample_loop(jfn, rng, SHAPE, cond_fn=jg, model_kwargs={"y": jnp.asarray(y)})
    init, steps = _jax_noise(rng, 20)
    got = td.p_sample_loop(tfn, SHAPE, noise=torch.from_numpy(init), noise_fn=_feed(steps),
                           cond_fn=tg, model_kwargs={"y": torch.from_numpy(y).long()},
                           device="cpu")
    _close(got, want, LOOP_RTOL)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_sample_loop_respaced(eta):
    jd, td = _pair(steps=50, respace="ddim10")
    jfn, tfn = _model(False)
    rng = jax.random.key(6)
    want = jd.ddim_sample_loop(jfn, rng, SHAPE, eta=eta)
    init, steps = _jax_noise(rng, 10)
    got = td.ddim_sample_loop(tfn, SHAPE, noise=torch.from_numpy(init),
                              noise_fn=_feed(steps), eta=eta, device="cpu")
    _close(got, want, LOOP_RTOL)
    # with its own generator, the loop is deterministic in the seed
    gen = [torch.Generator().manual_seed(3) for _ in range(2)]
    a, b = (td.ddim_sample_loop(tfn, SHAPE, generator=g, eta=eta, device="cpu")
            for g in gen)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


ENC = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3,
           num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
           num_head_channels=8, pool="attention")


def _classifier_pair():
    """The classifier with seeded weights: kernels ~ 1/sqrt(fan_in), the
    rest (norm scales included) ~ 1 + 0.1 N or 0.05 N."""
    rng = np.random.default_rng(7)
    jmodel = jax_unet.EncoderUNetModel(**ENC)
    params = jmodel.init(jax.random.key(0), jnp.zeros(SHAPE), jnp.zeros((2,)))["params"]

    def leaf(path, p):
        name = getattr(path[-1], "key", "")
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        return ((1.0 + 0.1 * z) if name == "scale" else 0.05 * z).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, params)
    tmodel = port_unet.EncoderUNetModel(**ENC)
    tmodel.load_state_dict(flax_encoder_unet_to_torch(params, tmodel), strict=True)
    tmodel.requires_grad_(False).eval()

    def jfn(x, t):
        return jmodel.apply({"params": params}, x, t)

    return jfn, tmodel


def test_classifier_cond_fn_matches_jax_and_spares_the_weights():
    jfn, tmodel = _classifier_pair()
    x = _x(8)
    t = np.array([10.0, 700.0], np.float32)
    y = np.array([0, 2], np.int32)
    want = j_cond_fn(jfn, scale=2.5)(jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(y))
    cond = t_cond_fn(lambda xx, tt: tmodel(xx, tt), scale=2.5)
    with torch.no_grad():  # the sampler's mode; cond_fn turns autograd on itself
        got = cond(torch.from_numpy(x), torch.from_numpy(t), y=torch.from_numpy(y).long())
    assert not got.requires_grad
    assert all(p.grad is None for p in tmodel.parameters())
    _close(got, want, GRAD_RTOL)
    with pytest.raises(ValueError, match="labels"):
        cond(torch.from_numpy(x), torch.from_numpy(t))


def test_ddim_loop_with_classifier_guidance():
    jfn_c, tmodel = _classifier_pair()
    jd, td = _pair(steps=50, respace="ddim10")
    jfn, tfn = _model(False)
    y = np.array([2, 1], np.int32)
    rng = jax.random.key(9)
    want = jd.ddim_sample_loop(jfn, rng, SHAPE, cond_fn=j_cond_fn(jfn_c, 3.0),
                               model_kwargs={"y": jnp.asarray(y)})
    init, steps = _jax_noise(rng, 10)
    with torch.no_grad():
        got = td.ddim_sample_loop(tfn, SHAPE, noise=torch.from_numpy(init),
                                  noise_fn=_feed(steps),
                                  cond_fn=t_cond_fn(lambda xx, tt: tmodel(xx, tt), 3.0),
                                  model_kwargs={"y": torch.from_numpy(y).long()},
                                  device="cpu")
    _close(got, want, LOOP_RTOL)
