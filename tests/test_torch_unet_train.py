"""Parity of the port's train step (vaw_torch/train/trainer.py) with the JAX
package's training_losses + jax.value_and_grad + fused_adamw_ema on the small
UNet of tests/test_torch_unet.py (LDM's structure: 32x32x4 latents, 32
channels, mult (1, 2), attention at 16x16 with heads of 8). The JAX UNet's
attention is routed through the Pallas kernels in interpret mode
(multi_head_attention_packed is patched to use_pallas=True inside the test;
the JAX package is not edited): its four 16x16 blocks run _flash_p5, so both
_fwd_kernel_p5 and _bwd_kernel_p5 are on the compared path.

Label dropout: the JAX UNet honours force_drop_ids in training
(vaw_tpu/models/unet.py:272-287), so both steps get the ids of the test's
draw. Both packages start from one state (flax_train_state_to_torch) and get
the same batch, t, noise and drop ids for two steps. The bounds are those of
tests/test_torch_uvit_train.py: f32 grads per leaf within 1e-4 * max|g| +
1e-7; params and EMA within 2e-6 where the grads are resolved, here above
1e-2 of the leaf's max (else Adam's largest move); mu within 1e-4 * max|mu|
and nu within 2e-4 * max|nu|. Six conv biases sit right before a GroupNorm
of one channel a group, which cancels them: their gradients are exact zeros
computed as 1e-9 of float noise, so their params are held only to Adam's
largest move and their moments to noise. For bf16 compute, the loss is held
within 2e-2 of the JAX bf16 step and the gradient, all leaves together,
within 5e-2 of its max and of its norm: the leaves that a GroupNorm cancels
in part or whole carry bf16 rounding noise, which differs elementwise
between any two bf16 implementations, so they are not held leaf by leaf.
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
from vaw_torch.models.convert import flax_train_state_to_torch, flax_unet_to_torch
from vaw_torch.models.unet import UNetModel
from vaw_torch.train import Trainer
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.core import GaussianDiffusion as JaxDiffusion
from vaw_tpu.core import ModelMeanType as JaxMeanType
from vaw_tpu.core import get_named_beta_schedule, make_schedule
from vaw_tpu.models.unet import UNetModel as JaxUNet
from vaw_tpu.ops import attention as jax_attention
from vaw_tpu.ops import flash_attention as jax_flash
from vaw_tpu.train import trainer as jax_trainer
from vaw_tpu.train.fused_opt import fused_adamw_ema

DROP = 0.5
SMALL = dict(image_size=32, in_channels=4, model_channels=32, out_channels=4,
             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
             num_head_channels=8, num_classes=10, drop_label_prob=DROP)
N = 4


def _cfg(amp=False):
    return TrainConfig(
        model="LDM", image_size=32, in_chans=4, num_classes=10, class_cond=True,
        drop_label_prob=DROP, batch_size=N, weight_type="lambda", mean_type="EPSILON",
        path_type="cosine", amp=amp, lr=1e-3, betas=(0.9, 0.95), weight_decay=0.01,
        ema_decay=0.9, total_steps=10, cosine_decay=True, seed=0)


def _randomize(params, seed):
    """Seeded noise in every leaf, the zero-initialised ones included."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(p.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = z * (0.3 if name == "embedding" else 0.05)
        return jnp.asarray(z, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _draws(seed):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.standard_normal((N, 32, 32, 4)).astype(np.float32),
        "label": rng.integers(0, 10, N).astype(np.int32),
        "t": np.array([37, 811, 400, 5], np.int32),
        "noise": rng.standard_normal((N, 32, 32, 4)).astype(np.float32),
        "drop": np.array([1, 0, 0, 1], np.int32),
    }


def _jax_side(amp):
    cfg = _cfg(amp)
    model = JaxUNet(**SMALL, dtype=jnp.bfloat16 if amp else jnp.float32)
    params = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                        jnp.zeros((1,), jnp.int32))["params"]
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
    model = UNetModel(**SMALL, compute_dtype=cfg.compute_dtype)
    diffusion = TorchDiffusion(
        schedule=torch_schedule(torch_betas("cosine", 1000)),
        model_mean_type=TorchMeanType.EPSILON, weight_type="lambda")
    trainer = Trainer(cfg, model, diffusion)
    state = trainer.init_state()
    conv = flax_train_state_to_torch(params, ema, opt_state, model)
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


def _assert_grads(got, want_tree, model, rel):
    want = flax_unet_to_torch(jax.tree_util.tree_map(np.asarray, want_tree), model)
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-7, err_msg=k)


@pytest.fixture
def pallas_unet(monkeypatch):
    """The JAX UNet's attention through _flash_p5 in interpret mode."""
    packed = jax_attention.multi_head_attention_packed
    monkeypatch.setattr(jax_attention, "multi_head_attention_packed",
                        lambda qkv, **kw: packed(qkv, **dict(kw, use_pallas=True)))
    calls = []
    real = jax_flash._flash_p5
    monkeypatch.setattr(jax_flash, "_flash_p5", lambda *a: calls.append(1) or real(*a))
    return calls


def test_small_unet_train_steps_match_jax_pallas_interpret(pallas_unet):
    cfg, params, value_and_grad = _jax_side(amp=False)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    trainer, state = _torch_side(cfg, params, ema, opt_state)
    resolved, signal = None, {}
    for step in range(2):
        d = _draws(seed=10 + step)
        batch = _feed(trainer, d)
        loss, grads = value_and_grad(params, d)
        g = flax_unet_to_torch(jax.tree_util.tree_map(np.asarray, grads), trainer.model)
        # Leaves above float noise: the conv biases that a one-channel-a-group
        # GroupNorm cancels have exact-zero gradients (1e-9 of noise here),
        # which Adam scales up to random moves of lr.
        signal = {k: signal.get(k, True) and v.abs().max().item() > 1e-6
                  for k, v in g.items()}
        # Resolved: |g| above 1e-2 of its leaf's max (relative error <= 1e-2).
        mask = {k: np.abs(v.numpy()) > 1e-2 * np.abs(v.numpy()).max()
                for k, v in g.items()}
        resolved = mask if resolved is None else {k: resolved[k] & mask[k] for k in mask}
        got_loss, got_grads = _port_grads(trainer, state, batch)
        assert got_loss == pytest.approx(float(loss), rel=1e-5)
        _assert_grads(got_grads, grads, trainer.model, 1e-4)
        params, ema, opt_state = fused_adamw_ema(
            params, grads, opt_state, ema, lr_fn=jax_trainer.warmup_cosine_lr(cfg),
            b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
            weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
        state, metrics = trainer.step(state, batch)
        assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)
    assert pallas_unet, "the JAX UNet did not run the Pallas _flash_p5 kernels"
    assert state.step == 2 and state.count == int(opt_state[0].count) == 2
    want = flax_train_state_to_torch(params, ema, opt_state, trainer.model)
    max_move = 2 * cfg.lr * (1 + cfg.weight_decay)
    assert sum(not v for v in signal.values()) == 6
    for k in state.params:
        for mine, theirs in ((state.params[k].detach(), want["params"][k]),
                             (state.ema[k], want["ema"][k])):
            diff = np.abs(mine.numpy() - theirs.numpy())
            if signal[k]:
                assert diff[resolved[k]].max(initial=0) <= 2e-6, k
            assert diff.max() <= max_move, k
        if not signal[k]:
            assert state.mu[k].abs().max() < 1e-8 and state.nu[k].abs().max() < 1e-16
            continue
        for mine, theirs, rel in ((state.mu[k], want["opt"]["mu"][k], 1e-4),
                                  (state.nu[k], want["opt"]["nu"][k], 2e-4)):
            w = theirs.numpy()
            np.testing.assert_allclose(mine.numpy(), w, rtol=0,
                                       atol=rel * np.abs(w).max() + 1e-12, err_msg=k)


def test_small_unet_bf16_step_near_jax_bf16():
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
    want = flax_unet_to_torch(jax.tree_util.tree_map(np.asarray, grads), trainer.model)
    got = np.concatenate([got_grads[k].numpy().ravel() for k in want])
    ref = np.concatenate([want[k].numpy().ravel() for k in want])
    assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()
    assert np.linalg.norm(got - ref) <= 5e-2 * np.linalg.norm(ref)
