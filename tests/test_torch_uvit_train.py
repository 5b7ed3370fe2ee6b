"""Parity of the port's train step (vaw_torch/train/trainer.py) with the JAX
package's training_losses + jax.value_and_grad + fused_adamw_ema on a tiny
U-ViT (embed 64, depth 5, 4 heads of 16, 8x8x4 latents, patch 2, 10
classes: T = 18). The JAX U-ViT's attention is routed through the Pallas
_flash kernels in interpret mode (multi_head_attention_packed is patched to
use_pallas=True inside the test; the JAX package is not edited), so both
directions of _fwd_kernel and _bwd_kernel are on the compared path.

Label dropout: in training the JAX U-ViT draws its own drop ids from its
"label_dropout" rng and ignores force_drop_ids (vaw_tpu/models/uvit.py:
110-118); the port's model honours the ids its Trainer draws. The test
computes the ids the JAX step draws (the root-scope make_rng of that
stream, as the JAX trainer passes fold_in(rng, 4)), checks that the JAX
model dropped exactly those, and feeds them to the port's draw.

Both packages start from one state (flax_train_state_to_torch) and get the
same batch, t, noise and drop ids for two steps. The bounds are those of
tests/test_torch_train.py: f32 grads per leaf within 1e-4 * max|g| + 1e-7;
params and EMA within 2e-6 where the grads are resolved (else Adam's
largest move); mu within 1e-4 * max|mu| and nu within 2e-4 * max|nu|; and
for bf16 compute, the loss within 2e-2 and the grads within 5e-2 * max|g|
of the JAX bf16 step.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.core import GaussianDiffusion as TorchDiffusion
from vaw_torch.core import ModelMeanType as TorchMeanType
from vaw_torch.core import get_named_beta_schedule as torch_betas
from vaw_torch.core import make_schedule as torch_schedule
from vaw_torch.models.convert import flax_train_state_to_torch, flax_uvit_to_torch
from vaw_torch.models.uvit import UViT
from vaw_torch.train import Trainer
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.core import GaussianDiffusion as JaxDiffusion
from vaw_tpu.core import ModelMeanType as JaxMeanType
from vaw_tpu.core import get_named_beta_schedule, make_schedule
from vaw_tpu.models.uvit import UViT as JaxUViT
from vaw_tpu.ops import attention as jax_attention
from vaw_tpu.ops import flash_attention as jax_flash
from vaw_tpu.train import trainer as jax_trainer
from vaw_tpu.train.fused_opt import fused_adamw_ema

DROP = 0.5
TINY = dict(image_size=8, patch_size=2, in_channels=4, embed_dim=64, depth=5,
            num_heads=4, num_classes=10, class_dropout_prob=DROP)
N = 4


def _cfg(amp=False):
    return TrainConfig(
        model="U-ViT-S", image_size=8, patch_size=2, in_chans=4, num_classes=10,
        class_cond=True, drop_label_prob=DROP, batch_size=N, weight_type="lambda",
        mean_type="EPSILON", path_type="cosine", amp=amp, lr=1e-3,
        betas=(0.9, 0.95), weight_decay=0.01, ema_decay=0.9, total_steps=10,
        cosine_decay=True, seed=0)


def _randomize(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(p.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = z * (0.3 if name in ("embedding", "pos_embed") else 0.05)
        return jnp.asarray(z, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


class _DropIds(nn.Module):
    """The U-ViT's own draw (vaw_tpu/models/uvit.py:110-114) at the root
    scope, where the U-ViT calls make_rng."""

    @nn.compact
    def __call__(self, n):
        return jax.random.uniform(self.make_rng("label_dropout"), (n,)) < DROP


def _draws(seed):
    rng = np.random.default_rng(seed)
    key = jax.random.fold_in(jax.random.key(seed), 4)
    drop = np.asarray(_DropIds().apply({}, N, rngs={"label_dropout": key}))
    return {
        "image": rng.standard_normal((N, 8, 8, 4)).astype(np.float32),
        "label": rng.integers(0, 10, N).astype(np.int32),
        "t": np.array([37, 811, 400, 5], np.int32),
        "noise": rng.standard_normal((N, 8, 8, 4)).astype(np.float32),
        "key": key, "drop": drop.astype(np.int32),
    }


def _jax_side(amp):
    cfg = _cfg(amp)
    model = JaxUViT(**TINY, dtype=jnp.bfloat16 if amp else jnp.float32)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                        jnp.zeros((1,), jnp.int32))["params"]
    params = _randomize(params, seed=1)
    diffusion = JaxDiffusion(
        schedule=make_schedule(get_named_beta_schedule("cosine", 1000)),
        model_mean_type=JaxMeanType.EPSILON, weight_type="lambda")

    def loss_fn(p, d):
        def model_fn(xt, t, **kw):  # as the JAX trainer calls it (trainer.py:310-317)
            return model.apply({"params": p}, xt, t, train=True,
                               rngs={"label_dropout": d["key"]}, **kw)
        terms = diffusion.training_losses(
            model_fn, jnp.asarray(d["image"]), jnp.asarray(d["t"]),
            jnp.asarray(d["noise"]), model_kwargs={"y": jnp.asarray(d["label"])})
        return jnp.mean(terms["loss"])

    return cfg, model, params, jax.jit(jax.value_and_grad(loss_fn))


def _torch_side(cfg, params, ema, opt_state):
    model = UViT(**TINY, compute_dtype=cfg.compute_dtype)
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
    grads = {k: p.grad.clone() for k, p in state.params.items()}
    for p in state.params.values():
        p.grad = None
    return loss.item(), grads


def _assert_grads(got, want_tree, rel):
    want = flax_uvit_to_torch(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-7, err_msg=k)


@pytest.fixture
def pallas_uvit(monkeypatch):
    """The JAX U-ViT's attention through _flash in interpret mode."""
    packed = jax_attention.multi_head_attention_packed
    monkeypatch.setattr(jax_attention, "multi_head_attention_packed",
                        lambda qkv, **kw: packed(qkv, **dict(kw, use_pallas=True)))
    calls = []
    real = jax_flash._flash
    monkeypatch.setattr(jax_flash, "_flash", lambda *a: calls.append(1) or real(*a))
    return calls


def test_the_jax_step_drops_the_ids_the_test_feeds():
    cfg, model, params, _ = _jax_side(amp=False)
    d = _draws(seed=10)
    assert 0 < d["drop"].sum() < N  # both kinds of row
    x, t, y = (jnp.asarray(d[k]) for k in ("image", "t", "label"))
    drawn = model.apply({"params": params}, x, t, y, train=True,
                        rngs={"label_dropout": d["key"]})
    forced = model.apply({"params": params}, x, t, y,
                         force_drop_ids=jnp.asarray(d["drop"]))
    np.testing.assert_array_equal(np.asarray(drawn), np.asarray(forced))


def test_tiny_uvit_train_steps_match_jax_pallas_interpret(pallas_uvit):
    cfg, _, params, value_and_grad = _jax_side(amp=False)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    trainer, state = _torch_side(cfg, params, ema, opt_state)
    resolved = None
    for step in range(2):
        d = _draws(seed=10 + step)
        batch = _feed(trainer, d)
        loss, grads = value_and_grad(params, d)
        g = flax_uvit_to_torch(jax.tree_util.tree_map(np.asarray, grads))
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
    assert pallas_uvit, "the JAX U-ViT did not run the Pallas _flash kernels"
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


def test_tiny_uvit_bf16_step_near_jax_bf16():
    cfg, _, params, value_and_grad = _jax_side(amp=True)
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
