"""Parity of the port's train step (vaw_torch/train/trainer.py, through the
DiT at training and the GaussianDiffusion loss) with the JAX package's
training_losses + jax.value_and_grad + fused_adamw_ema, on a tiny DiT
(hidden 128, 2 heads of 64, depth 2, 32x32x4 latents, T = 256: the JAX
p6 attention gate admits it, and VAW_FLASH_INTERPRET=1 routes the JAX DiT
through the Pallas forward and backward kernels in interpret mode).

Both packages start from one state (flax_train_state_to_torch), with the
zero-initialised adaLN-Zero modulation and head randomised, and get the
same batch, t, noise and label-drop ids (the Trainer's draw method is
replaced), for two steps.

Tolerances:
- f32 grads per leaf within 1e-4 * max|g| + 1e-7 (f32 on both sides,
  different summation order);
- f32 params and EMA after the steps atol 2e-6, 0.2 % of one lr-1e-3
  step, wherever the grads are resolved by the grad bound above. Where a
  grad is below that bound (the key bias, whose true gradient is 0 because
  softmax ignores a shift shared by all keys, holds rounding noise only)
  Adam's update g / (|g| + eps) has no defined sign, and the two packages
  are held only to Adam's largest move, lr (1 + weight decay) per step;
  mu within 1e-4 * max|mu| and nu within 2e-4 * max|nu| (they hold g and
  g**2);
- bf16 compute (the port's explicit compute dtype against the JAX model's
  dtype=bf16): the loss within 2e-2 and the grads within 5e-2 * max|g| of
  the JAX bf16 step, since the two round activations to bf16 at different
  places and the error grows through the residual stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.core import GaussianDiffusion as TorchDiffusion
from vaw_torch.core import ModelMeanType as TorchMeanType
from vaw_torch.core import get_named_beta_schedule as torch_betas
from vaw_torch.core import make_schedule as torch_schedule
from vaw_torch.models.convert import flax_dit_to_torch, flax_train_state_to_torch
from vaw_torch.models.dit import DiT
from vaw_torch.models.layers import LabelEmbedder
from vaw_torch.train import Trainer
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.core import GaussianDiffusion as JaxDiffusion
from vaw_tpu.core import ModelMeanType as JaxMeanType
from vaw_tpu.core import get_named_beta_schedule, make_schedule
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.models.layers import LabelEmbedder as JaxLabelEmbedder
from vaw_tpu.train import trainer as jax_trainer
from vaw_tpu.train.fused_opt import fused_adamw_ema

TINY = dict(image_size=32, patch_size=2, in_channels=4, hidden_size=128,
            depth=2, num_heads=2, num_classes=10, class_dropout_prob=0.1)
N = 2


def _cfg(amp=False):
    return TrainConfig(
        model="DiT-S", image_size=32, patch_size=2, in_chans=4, num_classes=10,
        class_cond=True, drop_label_prob=0.1, batch_size=N, weight_type="lambda",
        mean_type="EPSILON", path_type="cosine", amp=amp, lr=1e-3,
        betas=(0.9, 0.95), weight_decay=0.01, ema_decay=0.9, total_steps=10,
        cosine_decay=True, seed=0)


def _randomize(params, seed):
    """Seeded numpy noise in every leaf, the zero-initialised adaLN-Zero
    modulation and head included: kernels ~ 1/sqrt(fan_in), biases and
    tables ~ 0.05-0.3."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        std = (1.0 / np.sqrt(np.prod(p.shape[:-1])) if name == "kernel"
               else 0.3 if name == "embedding" else 0.05)
        return jnp.asarray(rng.standard_normal(p.shape) * std, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _draws(seed):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.standard_normal((N, 32, 32, 4)).astype(np.float32),
        "label": rng.integers(0, 10, N).astype(np.int32),
        "t": np.array([37, 811], np.int32),
        "noise": rng.standard_normal((N, 32, 32, 4)).astype(np.float32),
        "drop": np.array([0, 1], np.int32),
    }


def _jax_side(amp):
    cfg = _cfg(amp)
    model = JaxDiT(**TINY, dtype=jnp.bfloat16 if amp else jnp.float32)
    params = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 4)),
                        jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    params = _randomize(params, seed=1)
    diffusion = JaxDiffusion(
        schedule=make_schedule(get_named_beta_schedule("cosine", 1000)),
        model_mean_type=JaxMeanType.EPSILON, weight_type="lambda")

    def loss_fn(p, d):
        def model_fn(xt, t, **kw):
            return model.apply({"params": p}, xt, t, train=True,
                               force_drop_ids=jnp.asarray(d["drop"]), **kw)
        terms = diffusion.training_losses(
            model_fn, jnp.asarray(d["image"]), jnp.asarray(d["t"]),
            jnp.asarray(d["noise"]), model_kwargs={"y": jnp.asarray(d["label"])})
        return jnp.mean(terms["loss"])

    return cfg, params, jax.jit(jax.value_and_grad(loss_fn))


def _torch_side(cfg, params, ema, opt_state):
    model = DiT(**TINY, compute_dtype=cfg.compute_dtype)
    diffusion = TorchDiffusion(
        schedule=torch_schedule(torch_betas("cosine", 1000)),
        model_mean_type=TorchMeanType.EPSILON, weight_type="lambda")
    trainer = Trainer(cfg, model, diffusion)
    state = trainer.init_state()
    conv = flax_train_state_to_torch(params, ema, opt_state)
    with torch.no_grad():
        for k in state.params:
            state.params[k].copy_(conv["params"][k])
            state.ema[k].copy_(conv["ema"][k])
            state.mu[k].copy_(conv["opt"]["mu"][k])
            state.nu[k].copy_(conv["opt"]["nu"][k])
    state.count = conv["opt"]["count"]
    return trainer, state


def _feed(trainer, d):
    """Replace the Trainer's draws with the test's numbers; the batch."""
    trainer.draw = lambda batch: {
        "t": torch.from_numpy(d["t"]).long(),
        "noise": torch.from_numpy(d["noise"]), "latent": None,
        "drop": torch.from_numpy(d["drop"])}
    return {"image": torch.from_numpy(d["image"]),
            "label": torch.from_numpy(d["label"]).long()}


def _port_grads(trainer, state, batch):
    for p in state.params.values():
        p.grad = None
    loss, _ = trainer.loss_fn(batch, trainer.draw(batch))
    loss.backward()
    loss = loss.detach()
    grads = {k: p.grad.clone() for k, p in state.params.items()}
    for p in state.params.values():
        p.grad = None
    return loss.item(), grads


def _assert_grads(got, want_tree, rel):
    want = flax_dit_to_torch(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-7, err_msg=k)


def test_tiny_dit_train_steps_match_jax_pallas_interpret(monkeypatch):
    monkeypatch.setenv("VAW_FLASH_INTERPRET", "1")
    cfg, params, value_and_grad = _jax_side(amp=False)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    trainer, state = _torch_side(cfg, params, ema, opt_state)
    resolved = None
    for step in range(2):
        d = _draws(seed=10 + step)
        batch = _feed(trainer, d)
        loss, grads = value_and_grad(params, d)
        g = flax_dit_to_torch(jax.tree_util.tree_map(np.asarray, grads))
        mask = {k: np.abs(v.numpy()) > 1e-4 * np.abs(v.numpy()).max() + 1e-7
                for k, v in g.items()}
        resolved = mask if resolved is None else {k: resolved[k] & mask[k] for k in mask}
        got_loss, got_grads = _port_grads(trainer, state, batch)
        assert got_loss == pytest.approx(float(loss), rel=1e-5)
        _assert_grads(got_grads, grads, 1e-4)
        params, ema, opt_state = fused_adamw_ema(
            params, grads, opt_state, ema, lr_fn=jax_trainer.warmup_cosine_lr(cfg),
            b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
            weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
        state, metrics = trainer.step(state, batch)
        assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert float(metrics["grad_norm"]) > 0
    assert state.step == 2 and state.count == int(opt_state[0].count) == 2
    want = flax_train_state_to_torch(params, ema, opt_state)
    max_move = 2 * cfg.lr * (1 + cfg.weight_decay)
    for k in state.params:
        for mine, theirs in ((state.params[k].detach(), want["params"][k]),
                             (state.ema[k], want["ema"][k])):
            diff = np.abs(mine.numpy() - theirs.numpy())
            assert diff[resolved[k]].max(initial=0) <= 2e-6, k
            assert diff.max() <= max_move, k
        for mine, theirs, rel in ((state.mu[k], want["opt"]["mu"][k], 1e-4),
                                  (state.nu[k], want["opt"]["nu"][k], 2e-4)):
            w = theirs.numpy()
            np.testing.assert_allclose(mine.numpy(), w, rtol=0,
                                       atol=rel * np.abs(w).max() + 1e-12, err_msg=k)


def test_tiny_dit_bf16_step_near_jax_bf16():
    cfg, params, value_and_grad = _jax_side(amp=True)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    trainer, state = _torch_side(cfg, params, ema, opt_state)
    assert trainer.model.compute_dtype == torch.bfloat16
    d = _draws(seed=20)
    batch = _feed(trainer, d)
    loss, grads = value_and_grad(params, d)
    got_loss, got_grads = _port_grads(trainer, state, batch)
    assert all(g.dtype == torch.float32 for g in got_grads.values())
    assert got_loss == pytest.approx(float(loss), rel=2e-2)
    _assert_grads(got_grads, grads, 5e-2)


@pytest.mark.parametrize("train,force", [(False, None), (True, [0, 1, 1, 0]),
                                         (False, [1, 1, 0, 0])])
def test_label_embedder_drop_matches_jax(train, force):
    jmod = JaxLabelEmbedder(num_classes=10, hidden_size=8, dropout_prob=0.1)
    labels = np.array([3, 7, 0, 9], np.int32)
    variables = jmod.init(jax.random.key(0), jnp.asarray(labels))
    fd = None if force is None else np.array(force, np.int32)
    want = jmod.apply(variables, jnp.asarray(labels), train=train,
                      force_drop_ids=None if fd is None else jnp.asarray(fd))
    tmod = LabelEmbedder(10, 8, 0.1)
    with torch.no_grad():
        tmod.embedding_table.weight.copy_(torch.from_numpy(
            np.array(variables["params"]["Embed_0"]["embedding"])))
    got = tmod(torch.from_numpy(labels).long(), train=train,
               force_drop_ids=None if fd is None else torch.from_numpy(fd))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_label_dropout_draws_from_the_generator():
    tmod = LabelEmbedder(10, 4, 0.5)
    labels = torch.arange(10).repeat(40)
    a = tmod(labels, train=True, generator=torch.Generator().manual_seed(1))
    b = tmod(labels, train=True, generator=torch.Generator().manual_seed(1))
    null = tmod.embedding_table.weight[10]
    dropped = (a == null).all(dim=1)
    assert torch.equal(a, b) and 120 < int(dropped.sum()) < 280
    assert torch.equal(tmod(labels), tmod.embedding_table(labels))  # eval: no drop


def test_trainer_refuses_unported_features():
    cfg = _cfg()
    model = DiT(**TINY)
    diffusion = TorchDiffusion(schedule=torch_schedule(torch_betas("cosine", 1000)))
    cfg.grad_clip, cfg.opt_bf16_moments = 1.0, True
    with pytest.raises(ValueError, match="fused optimizer"):
        Trainer(cfg, model, diffusion).init_state()
