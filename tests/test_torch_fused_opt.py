"""Parity of the port's optimizer (vaw_torch/train/fused_opt.py and the
unfused AdamW of vaw_torch/train/trainer.py) with the JAX package's
fused_adamw_ema and its optax chain, over several steps from one state
carried across with vaw_torch.models.convert.flax_train_state_to_torch.

The state is a small DiT's params (so the conversion rules apply), the
grads are seeded numpy noise, and both sides run warmup then cosine lr
with weight decay.

Tolerances: params and EMA atol 1e-7 + rtol 1e-6; mu and nu rtol 1e-5
plus 1e-6 of the leaf's max|moment| (f32 on both sides; torch may fuse a
multiply-add that XLA rounds twice, and b1*m + (1-b1)*g cancels where m
and g differ in sign, so an ulp of the terms is a large relative error of
a small sum); bf16 moments within one bf16 ulp (2**-7 relative, 2**-8 of
the max), since a value within an f32 ulp of a rounding boundary may round
either way on store. With bf16 moments the params and EMA are held to
atol 1e-5, 1 % of one lr-1e-3 step: a moment stored one bf16 ulp apart
moves the next update by up to 2**-8 of a step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaw_torch.models.convert import flax_dit_to_torch, flax_train_state_to_torch
from vaw_torch.train.fused_opt import INT32_MAX, fused_adamw_ema, safe_int32_increment
from vaw_torch.train.state import ema_update
from vaw_torch.train.trainer import (
    clip_by_global_norm_,
    make_optimizer,
    warmup_cosine_lr,
)
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.train import trainer as jax_trainer
from vaw_tpu.train.fused_opt import fused_adamw_ema as jax_fused

SMALL = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=64,
             depth=2, num_heads=2, num_classes=10, class_dropout_prob=0.1)


def _cfg(**kw):
    base = dict(model="DiT-S", amp=False, lr=1e-3, warmup_steps=2,
                cosine_decay=True, total_steps=6, final_lr=1e-5,
                weight_decay=0.01, ema_decay=0.9, betas=(0.9, 0.95))
    base.update(kw)
    return TrainConfig(**base)


def _params(seed=0):
    model = JaxDiT(**SMALL)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                        jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.1, jnp.float32), params)


def _grads(params, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale, jnp.float32), params)


def _torch_lists(conv, names):
    return ([conv["params"][k].clone() for k in names],
            [conv["ema"][k].clone() for k in names],
            [conv["opt"]["mu"][k].clone() for k in names],
            [conv["opt"]["nu"][k].clone() for k in names])


def _assert_state(names, got, params, ema, opt_state, bf16=False):
    want = flax_train_state_to_torch(params, ema, opt_state)
    p, e, m, v = got
    atol = 1e-5 if bf16 else 1e-7
    for i, k in enumerate(names):
        np.testing.assert_allclose(p[i].numpy(), want["params"][k].numpy(),
                                   atol=atol, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(e[i].numpy(), want["ema"][k].numpy(),
                                   atol=atol, rtol=1e-6, err_msg=k)
        for mine, theirs in ((m[i], want["opt"]["mu"][k]), (v[i], want["opt"]["nu"][k])):
            assert mine.dtype == theirs.dtype
            theirs = theirs.float().numpy()
            rtol, arel = (2 ** -7, 2 ** -8) if bf16 else (1e-5, 1e-6)
            np.testing.assert_allclose(mine.float().numpy(), theirs, rtol=rtol,
                                       atol=arel * np.abs(theirs).max(), err_msg=k)


@pytest.mark.parametrize("bf16_moments", [False, True])
@pytest.mark.parametrize("cosine", [True, False])
def test_fused_matches_jax_over_steps(bf16_moments, cosine):
    cfg = _cfg(cosine_decay=cosine)
    params = _params()
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    if bf16_moments:
        adam = opt_state[0]
        cast = lambda t: jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), t)  # noqa: E731
        opt_state = (optax.ScaleByAdamState(count=adam.count, mu=cast(adam.mu),
                                            nu=cast(adam.nu)),) + tuple(opt_state[1:])
    conv = flax_train_state_to_torch(params, ema, opt_state)
    names = sorted(conv["params"])
    p, e, m, v = _torch_lists(conv, names)
    assert m[0].dtype == (torch.bfloat16 if bf16_moments else torch.float32)
    count = conv["opt"]["count"]
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = _grads(params, rng)
        params, ema, opt_state = jax_fused(
            params, grads, opt_state, ema, lr_fn=jax_trainer.warmup_cosine_lr(cfg),
            b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
            weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
        g = flax_dit_to_torch(grads)
        count = fused_adamw_ema(
            p, [g[k] for k in names], m, v, e, count, lr_fn=warmup_cosine_lr(cfg),
            b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
            weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
    assert count == int(opt_state[0].count) == 5
    _assert_state(names, (p, e, m, v), params, ema, opt_state, bf16=bf16_moments)


def test_unfused_clip_path_matches_optax_chain():
    """optax.chain(clip_by_global_norm, adamw) + ema_update against the
    port's AdamW with grad_clip: steps alternate between grads above the
    clip norm and below it."""
    cfg = _cfg(grad_clip=1.0, weight_decay=0.0)
    params = _params(seed=2)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    tx = jax_trainer.make_optimizer(cfg)
    opt_state = tx.init(params)
    conv = flax_train_state_to_torch(params, ema, opt_state)
    names = sorted(conv["params"])
    p, e, m, v = _torch_lists(conv, names)
    count = conv["opt"]["count"]
    opt = make_optimizer(cfg)
    rng = np.random.default_rng(3)
    for step in range(4):
        grads = _grads(params, rng, scale=0.2 if step % 2 == 0 else 1e-3)
        assert (float(optax.global_norm(grads)) > cfg.grad_clip) == (step % 2 == 0)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(
            lambda a, b: a * cfg.ema_decay + b * (1 - cfg.ema_decay), ema, params)
        g = flax_dit_to_torch(grads)
        count = opt.step(p, [g[k] for k in names], m, v, count)
        ema_update(p, e, cfg.ema_decay)
    assert count == 4
    _assert_state(names, (p, e, m, v), params, ema, opt_state)


def test_clip_has_no_epsilon_and_keeps_small_grads():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    clip_by_global_norm_(g, 1.0)
    assert g[0].tolist() == [0.6000000238418579, 0.800000011920929]
    small = [torch.tensor([0.3, 0.4])]
    clip_by_global_norm_(small, 1.0)
    assert small[0].tolist() == torch.tensor([0.3, 0.4]).tolist()


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 6, 9])
def test_warmup_cosine_lr_matches_jax(step):
    cfg = _cfg(total_steps=9, warmup_steps=3)
    want = float(jax_trainer.warmup_cosine_lr(cfg)(step))
    got = float(warmup_cosine_lr(cfg)(step))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_count_saturates_like_optax():
    for c in (0, 7, INT32_MAX - 1, INT32_MAX):
        assert safe_int32_increment(c) == int(
            optax.safe_int32_increment(jnp.asarray(c, jnp.int32)))


def test_convert_refuses_mismatched_counts():
    cfg = _cfg()
    params = _params()
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    sched = opt_state[2]
    bad = opt_state[:2] + (type(sched)(count=sched.count + 1),)
    with pytest.raises(ValueError, match="one count"):
        flax_train_state_to_torch(params, params, bad)
