"""Parity of the port's timestep resamplers (vaw_torch/core/weighting.py)
with the JAX package's (vaw_tpu/core/weighting.py:113-227), and of one
train step under the loss-aware resampler with the JAX trainer's
(vaw_tpu/train/trainer.py:109-116, 320-327, 411-421).

The vectorised ``update`` is held to the JAX class and to the sequential
per-item ring buffer of the reference (tools/resample.py:152-159) with
random (t, loss) batches that overfill some rows; counts and history must
be equal exactly (the fold only moves values). ``weights`` is held to the
JAX class within 1 f32 ulp (a mean and a sum in another order), and the
warm-up switch exactly. The train step feeds the port the JAX step's own
draws (t through the port's sampler, so the importance weights are the
port's), with two micro-batches; the loss within rel 1e-5, the folded
history within rel 1e-5 and its counts exactly.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.core import (
    GaussianDiffusion as TorchDiffusion,
    LossSecondMomentResampler,
    ResamplerState,
    UniformSampler,
    create_named_schedule_sampler,
)
from vaw_torch.core import ModelMeanType as TorchMeanType
from vaw_torch.core import get_named_beta_schedule as torch_betas
from vaw_torch.core import make_schedule as torch_schedule
from vaw_torch.models.convert import flax_train_state_to_torch
from vaw_torch.models.dit import DiT
from vaw_torch.train import Trainer
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.core import GaussianDiffusion as JaxDiffusion
from vaw_tpu.core import ModelMeanType as JaxMeanType
from vaw_tpu.core import get_named_beta_schedule, make_schedule
from vaw_tpu.core import weighting as jw
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.train import trainer as jax_trainer
from vaw_tpu.train.state import TrainState as JaxTrainState

T, H = 12, 4


def _sequential(hist, counts, ts, losses):
    """The reference's per-item ring buffer: append while not full, else
    shift left and append."""
    hist, counts = hist.copy(), counts.copy()
    for t, loss in zip(ts, losses):
        if counts[t] == H:
            hist[t, :-1] = hist[t, 1:]
            hist[t, -1] = loss
        else:
            hist[t, counts[t]] = loss
            counts[t] += 1
    return hist, counts


def _state(rng, fill):
    counts = rng.integers(0, H + 1, T).astype(np.int32) if fill else np.zeros(T, np.int32)
    hist = np.where(np.arange(H)[None] < counts[:, None],
                    rng.uniform(0.1, 2.0, (T, H)), 0.0).astype(np.float32)
    return hist, counts


@pytest.mark.parametrize("seed", range(6))
def test_update_matches_jax_and_the_sequential_ring(seed):
    rng = np.random.default_rng(seed)
    hist, counts = _state(rng, fill=seed % 2 == 1)
    n = int(rng.integers(1, 40))
    # Few distinct timesteps, so some rows get more than H arrivals.
    ts = rng.integers(0, T if seed < 3 else 3, n).astype(np.int32)
    losses = rng.uniform(0.0, 3.0, n).astype(np.float32)
    port = LossSecondMomentResampler(T, history_per_term=H)
    jres = jw.LossSecondMomentResampler(T, history_per_term=H)
    got = port.update(ResamplerState(torch.from_numpy(hist), torch.from_numpy(counts)),
                      torch.from_numpy(ts), torch.from_numpy(losses))
    want = jres.update(jw.ResamplerState(jnp.asarray(hist), jnp.asarray(counts)),
                       jnp.asarray(ts), jnp.asarray(losses))
    seq_hist, seq_counts = _sequential(hist, counts, ts, losses)
    assert got.loss_counts.dtype == torch.int32
    np.testing.assert_array_equal(got.loss_counts.numpy(), np.asarray(want.loss_counts))
    np.testing.assert_array_equal(got.loss_counts.numpy(), seq_counts)
    valid = np.arange(H)[None] < seq_counts[:, None]
    np.testing.assert_array_equal(got.loss_history.numpy(), np.asarray(want.loss_history))
    np.testing.assert_array_equal(got.loss_history.numpy()[valid], seq_hist[valid])


def test_weights_and_the_warm_up_switch():
    rng = np.random.default_rng(3)
    port = LossSecondMomentResampler(T, history_per_term=H)
    jres = jw.LossSecondMomentResampler(T, history_per_term=H)
    hist, counts = _state(rng, fill=True)
    counts[:] = H
    counts[5] = H - 1  # one row short: not warmed up
    for warm in (False, True):
        if warm:
            counts[5] = H
            hist[5] = rng.uniform(0.1, 2.0, H)
        got = port.weights(ResamplerState(torch.from_numpy(hist), torch.from_numpy(counts)))
        want = np.asarray(jres.weights(jw.ResamplerState(jnp.asarray(hist),
                                                         jnp.asarray(counts))))
        np.testing.assert_array_max_ulp(got.numpy(), want.astype(np.float32), maxulp=1)
        if warm:
            assert not np.allclose(got.numpy(), 1.0)
        else:
            np.testing.assert_array_equal(got.numpy(), np.ones(T, np.float32))


def test_sample_draws_by_weight_with_unbiasing_weights():
    port = LossSecondMomentResampler(T, history_per_term=H)
    hist = np.zeros((T, H), np.float32)
    hist[3] = 10.0  # row 3 dominates
    hist[hist == 0] = 0.01
    state = ResamplerState(torch.from_numpy(hist), torch.full((T,), H, dtype=torch.int32))
    t, w = port.sample(torch.Generator().manual_seed(0), state, 2000)
    t2, _ = port.sample(torch.Generator().manual_seed(0), state, 2000)
    assert torch.equal(t, t2) and t.dtype == torch.int64
    assert (t == 3).float().mean() > 0.9
    p = port.weights(state) / port.weights(state).sum()
    torch.testing.assert_close(w, 1.0 / (T * p[t]))
    cold = port.init_state()
    t, w = port.sample(torch.Generator().manual_seed(0), cold, 500)
    torch.testing.assert_close(w, torch.ones(500))
    assert len(torch.unique(t)) == T


def test_named_samplers():
    assert isinstance(create_named_schedule_sampler("uniform", T), UniformSampler)
    res = create_named_schedule_sampler("loss-second-moment", T)
    assert isinstance(res, LossSecondMomentResampler)
    assert (res.history_per_term, res.uniform_prob) == (10, 0.001)
    t, w = UniformSampler(T).sample(torch.Generator().manual_seed(0), 64)
    assert t.max() < T and torch.equal(w, torch.ones(64))
    with pytest.raises(NotImplementedError):
        create_named_schedule_sampler("bogus", T)


TINY = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2,
            num_heads=2, num_classes=10, class_dropout_prob=0.0)
STEPS = 10  # diffusion steps: every row warms up from a short fill


def _cfg():
    return TrainConfig(
        model="DiT-S", image_size=8, patch_size=2, in_chans=4, num_classes=10,
        class_cond=True, drop_label_prob=0.0, batch_size=6, grad_accumulation=2,
        weight_type="lambda", mean_type="EPSILON", path_type="cosine", amp=False,
        lr=1e-3, betas=(0.9, 0.95), weight_decay=0.01, ema_decay=0.9,
        total_steps=10, seed=0, diffusion_steps=STEPS,
        time_sampler="loss-second-moment")


def test_train_step_matches_the_jax_trainer():
    cfg = _cfg()
    rng = np.random.default_rng(4)
    jmodel = JaxDiT(**TINY)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                         jnp.zeros((1,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.1, jnp.float32), params)
    jdiff = JaxDiffusion(schedule=make_schedule(get_named_beta_schedule("cosine", STEPS)),
                         model_mean_type=JaxMeanType.EPSILON, weight_type="lambda")
    jtrainer = jax_trainer.Trainer(cfg, jmodel, jdiff, mesh=None)
    assert jtrainer.resampler is not None
    # A warmed-up history, so that t is importance-sampled.
    hist = rng.uniform(0.05, 2.0, (STEPS, 10)).astype(np.float32)
    jres_state = jw.ResamplerState(jnp.asarray(hist), jnp.full((STEPS,), 10, jnp.int32))
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jtrainer.tx.init(params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, ema_params=ema,
                           opt_state=opt_state, resampler=jres_state)
    batch = {"image": rng.standard_normal((6, 8, 8, 4)).astype(np.float32),
             "label": rng.integers(0, 10, 6).astype(np.int32)}
    step_rng = jax.random.fold_in(jtrainer.base_rng, 0)
    new_jstate, jmetrics = jax.jit(jtrainer._train_step)(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch), step_rng)

    # The JAX step's draws, micro-batch by micro-batch (trainer.py:300-330).
    draws = []
    for i in range(2):
        mrng = jax.random.fold_in(step_rng, i)
        t, w = jtrainer.resampler.sample(jax.random.fold_in(mrng, 0), jres_state, 3)
        noise = jax.random.normal(jax.random.fold_in(mrng, 1), (3, 8, 8, 4), jnp.float32)
        draws.append((np.asarray(t), np.asarray(w), np.array(noise)))

    model = DiT(**TINY)
    tdiff = TorchDiffusion(schedule=torch_schedule(torch_betas("cosine", STEPS)),
                           model_mean_type=TorchMeanType.EPSILON, weight_type="lambda")
    trainer = Trainer(cfg, model, tdiff)
    state = trainer.init_state()
    conv = flax_train_state_to_torch(params, ema, opt_state, resampler=jres_state)
    with torch.no_grad():
        for k in state.params:
            state.params[k].copy_(conv["params"][k])
            state.ema[k].copy_(conv["ema"][k])
    state.resampler = ResamplerState(conv["resampler"]["loss_history"].clone(),
                                     conv["resampler"]["loss_counts"].clone())
    fed = iter(draws)
    weights_seen = []

    def draw(mb):
        t, w, noise = next(fed)
        with mock.patch.object(torch, "multinomial",
                               lambda p, n, replacement, generator: torch.tensor(t).long()):
            t_port, w_port = trainer.resampler.sample(
                trainer.generator, trainer._resampler_state, len(t))
        np.testing.assert_allclose(w_port.numpy(), w, rtol=1e-5)
        weights_seen.append(w_port)
        return {"t": t_port, "weights": w_port, "noise": torch.from_numpy(noise),
                "latent": None, "drop": None}

    trainer.draw = draw
    tbatch = {"image": torch.from_numpy(batch["image"]),
              "label": torch.from_numpy(batch["label"]).long()}
    state, metrics = trainer.step(state, tbatch)
    assert len(weights_seen) == 2 and not torch.allclose(weights_seen[0], torch.ones(3))
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    np.testing.assert_array_equal(state.resampler.loss_counts.numpy(),
                                  np.asarray(new_jstate.resampler.loss_counts))
    np.testing.assert_allclose(state.resampler.loss_history.numpy(),
                               np.asarray(new_jstate.resampler.loss_history), rtol=1e-5)
    assert not np.array_equal(state.resampler.loss_history.numpy(), hist)
