"""Parity of the port's REPA pieces with the JAX package's: the four align
losses and projection_loss (vaw_torch/core/losses.py), the align term of
the diffusion loss with and without a learned-variance vb term
(core/diffusion.py), the DiT's projector tap (models/dit.py) with weights
carried by flax_dit_to_torch, and one REPA train step
(train/trainer.py) against the JAX package's loss, gradient and fused
AdamW+EMA on the same state and draws, the teacher run per micro-batch.
(The flow loss's align term and the MM-DiT's tap are held in
tests/test_torch_flow.py and tests/test_torch_mmdit.py.)

The train step: a DiT of hidden 64, depth 2, 2 heads, on 8x8x4 latents
(T = 16) stored as [mean | std] moments, the projector after block 1; its
teacher a MoCo-v3 FeatureViT (width 32, depth 1, patch 16) on the 64 px
pixels stored beside the latents (MoCo-v3 takes them unresized: a 4x4
grid, 16 tokens), built from one seeded timm state dict by both packages'
convert_timm_vit.

Tolerances: losses atol 1e-6, rtol 1e-5 (tests/test_torch_diffusion.py);
the f32 forward atol 1e-4 (tests/test_torch_dit.py:82); the train step as
tests/test_torch_train.py holds it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaw_torch.core as tc
import vaw_tpu.core as jc
from vaw_torch.core.losses import compute_align_loss, projection_loss
from vaw_torch.encoders import FeatureViT, convert_timm_vit, get_feature
from vaw_torch.models import build_model
from vaw_torch.models.convert import flax_dit_to_torch, flax_train_state_to_torch
from vaw_torch.models.dit import DiT
from vaw_torch.train import Trainer
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.core import losses as jlosses
from vaw_tpu.encoders import convert_timm_vit as jax_convert_timm_vit
from vaw_tpu.encoders import get_feature as jax_get_feature
from vaw_tpu.encoders.vit_backbone import FeatureViT as JaxFeatureViT
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.train import trainer as jax_trainer
from vaw_tpu.train.fused_opt import fused_adamw_ema

TOL = dict(atol=1e-6, rtol=1e-5)
ATOL = 1e-4
ALIGN_TYPES = ["cosine", "mse", "mse_l2", "nt_xent"]


def _features(seed, n=3, t=5, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, t, d)).astype(np.float32),
            rng.standard_normal((n, t, d)).astype(np.float32))


@pytest.mark.parametrize("align_type", ALIGN_TYPES)
def test_align_losses_match_jax(align_type):
    target, output = _features(0)
    want = jlosses.compute_align_loss(jnp.asarray(target), jnp.asarray(output), align_type)
    got = compute_align_loss(torch.from_numpy(target), torch.from_numpy(output), align_type)
    assert got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_nt_xent_temperature_and_unknown_type():
    target, output = _features(1)
    to = torch.from_numpy
    want = jlosses.compute_align_loss(jnp.asarray(target), jnp.asarray(output),
                                      "nt_xent", temperature=0.5)
    got = compute_align_loss(to(target), to(output), "nt_xent", temperature=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="temperature"):
        compute_align_loss(to(target), to(output), "nt_xent", temperature=0.0)
    with pytest.raises(ValueError, match="Unknown align loss type"):
        compute_align_loss(to(target), to(output), "l1")


def test_projection_loss_matches_jax():
    z, z_tilde = _features(2)
    want = jlosses.projection_loss(jnp.asarray(z), jnp.asarray(z_tilde))
    got = projection_loss(torch.from_numpy(z), torch.from_numpy(z_tilde))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _diffusion_pair(var_type, align_type):
    def build(m):
        return m.GaussianDiffusion(
            schedule=m.make_schedule(m.get_named_beta_schedule("cosine", 1000)),
            model_mean_type=m.ModelMeanType.EPSILON,
            model_var_type=m.ModelVarType[var_type], weight_type="lambda",
            gamma=0.5, learn_align=True, align_type=align_type)
    return build(jc), build(tc)


@pytest.mark.parametrize("align_type", ALIGN_TYPES)
@pytest.mark.parametrize("var_type", ["FIXED_LARGE", "LEARNED_RANGE"],
                         ids=["no_vb", "vb"])
def test_diffusion_align_term_matches_jax(var_type, align_type):
    """The align term is reported, and added times gamma only without a vb
    term (vaw_tpu/core/diffusion.py:493-507)."""
    jd, td = _diffusion_pair(var_type, align_type)
    learned = var_type == "LEARNED_RANGE"
    rng = np.random.default_rng(3)
    x0 = np.clip(rng.standard_normal((4, 4, 4, 3)) * 0.5, -1, 1).astype(np.float32)
    noise = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)
    t = np.array([0, 999, 17, 500], np.int32)
    feats, zs = _features(4, n=4)

    def jax_fn(x, tt, **kw):
        mean = jnp.tanh(0.5 * x) + (tt / 1000.0)[:, None, None, None]
        out = jnp.concatenate([mean, 0.9 * jnp.tanh(x)], -1) if learned else mean
        return out, jnp.asarray(zs)

    def torch_fn(x, tt, **kw):
        mean = torch.tanh(0.5 * x) + (tt / 1000.0)[:, None, None, None]
        out = torch.cat([mean, 0.9 * torch.tanh(x)], -1) if learned else mean
        return out, torch.from_numpy(zs)

    want = jd.training_losses(jax_fn, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                              features=jnp.asarray(feats))
    to = torch.from_numpy
    got = td.training_losses(torch_fn, to(x0), to(t).long(), to(noise),
                             features=to(feats))
    assert set(got) == set(want) == ({"mse", "align", "loss"} | ({"vb"} if learned else set()))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    if learned:
        np.testing.assert_allclose(got["loss"].numpy(), (got["mse"] + got["vb"]).numpy())
    else:
        np.testing.assert_allclose(got["loss"].numpy(),
                                   (got["mse"] + 0.5 * got["align"]).numpy(), **TOL)
    td.gamma = 0.0
    with pytest.raises(ValueError, match="gamma must be > 0"):
        td.training_losses(torch_fn, to(x0), to(t).long(), to(noise), features=to(feats))


DIT = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2,
           num_heads=2, num_classes=10, class_dropout_prob=0.1, learn_align=True,
           encoder_depth=1, z_dims=32, projector_dim=48)


def _randomize(params, seed):
    """Seeded noise in every leaf, the zero-initialised adaLN-Zero
    modulation and head included: kernels ~ 1/sqrt(fan_in), tables ~ 0.3,
    biases ~ 0.05."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        std = (1.0 / np.sqrt(np.prod(p.shape[:-1])) if name == "kernel"
               else 0.3 if name == "embedding" else 0.05)
        return jnp.asarray(rng.standard_normal(p.shape) * std, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _jax_dit(seed=1):
    model = JaxDiT(**DIT)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                        jnp.zeros((1,), jnp.int32))["params"]
    return model, _randomize(params, seed)


def test_dit_projector_tap_matches_jax():
    jmodel, params = _jax_dit()
    tmodel = DiT(**DIT)
    sd = flax_dit_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert {k for k in sd if k.startswith("projectors.")} == {
        f"projectors.{i}.{n}" for i in (0, 2, 4) for n in ("weight", "bias")}
    tmodel.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = rng.uniform(0, 999, 3).astype(np.float32)
    y = rng.integers(0, 10, 3).astype(np.int32)
    want, want_zs = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                          jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got, got_zs = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(y).long())
    assert got_zs.shape == (3, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_zs.numpy(), np.asarray(want_zs), atol=ATOL, rtol=0)
    with torch.no_grad():
        cfg_out = tmodel.forward_with_cfg(torch.from_numpy(x[:2]), torch.from_numpy(t[:2]),
                                          torch.from_numpy(y[:2]).long(), 1.5)
    assert cfg_out.shape == (2, 8, 8, 4)


def _cfg(**kw):
    base = dict(model="DiT-S", image_size=8, patch_size=2, in_chans=4, num_classes=10,
                class_cond=True, drop_label_prob=0.1, batch_size=2, weight_type="lambda",
                mean_type="EPSILON", path_type="cosine", amp=False, lr=1e-3,
                betas=(0.9, 0.95), weight_decay=0.01, ema_decay=0.9, total_steps=10,
                cosine_decay=True, seed=0, learn_align=True, enc_type="mocov3-vit-s",
                encoder_depth=1, z_dims=32, gamma=0.5, align_type="cosine")
    base.update(kw)
    return TrainConfig(**base)


def test_registry_builds_the_tapped_dit():
    cfg = _cfg(model="DiT-B", image_size=8, encoder_depth=8, z_dims=768)
    model = build_model(cfg, device="cpu")
    assert model.encoder_depth == 8 and model.projectors[-1].out_features == 768
    with pytest.raises(ValueError, match="encoder_depth"):
        build_model(_cfg(encoder_depth=0), device="cpu")


def _teachers():
    """The MoCo-v3 teacher of both packages from one seeded timm dict."""
    rng = np.random.default_rng(5)
    dim, patch = 32, 16

    def r(*shape, std=0.05, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(dim, 3, patch, patch, std=0.036),
          "patch_embed.proj.bias": r(dim), "cls_token": r(1, 1, dim, std=0.3),
          "pos_embed": r(1, 17, dim, std=0.3), "norm.weight": r(dim, mean=1.0, std=0.1),
          "norm.bias": r(dim)}
    for n in ("norm1", "norm2"):
        sd[f"blocks.0.{n}.weight"] = r(dim, mean=1.0, std=0.1)
        sd[f"blocks.0.{n}.bias"] = r(dim)
    for n, (o, k) in {"attn.qkv": (3 * dim, dim), "attn.proj": (dim, dim),
                      "mlp.fc1": (4 * dim, dim), "mlp.fc2": (dim, 4 * dim)}.items():
        sd[f"blocks.0.{n}.weight"] = r(o, k, std=1 / np.sqrt(k))
        sd[f"blocks.0.{n}.bias"] = r(o)
    kw = dict(image_size=64, patch_size=16, embed_dim=dim, depth=1, num_heads=2,
              fixed_sincos_pos=True)
    jmodel = JaxFeatureViT(**kw)
    jparams = jax_convert_timm_vit(sd, depth=1)
    tmodel = FeatureViT(**kw)
    tmodel.load_state_dict(convert_timm_vit(sd, depth=1), strict=True)
    return (lambda x: jmodel.apply({"params": jparams}, x)), tmodel.eval().requires_grad_(False)


def _draws(seed, n=2):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((n, 8, 8, 4)).astype(np.float32)
    std = rng.uniform(0.1, 0.5, (n, 8, 8, 4)).astype(np.float32)
    return {"image": np.concatenate([mean, std], -1),
            "label": rng.integers(0, 10, n).astype(np.int32),
            "pixels": rng.uniform(0, 255, (n, 64, 64, 3)).astype(np.float32),
            "t": rng.integers(0, 1000, n).astype(np.int32),
            "noise": rng.standard_normal((n, 8, 8, 4)).astype(np.float32),
            "latent": rng.standard_normal((n, 8, 8, 4)).astype(np.float32),
            "drop": (np.arange(n) % 2).astype(np.int32)}


def _feed(trainer, d):
    """Replace the Trainer's draws with the test's numbers (sliced to each
    micro-batch); the batch."""
    done = [0]

    def draw(batch):
        n = batch["image"].shape[0]
        i = done[0]
        done[0] += n
        return {"t": torch.from_numpy(d["t"][i:i + n]).long(), "weights": None,
                "noise": torch.from_numpy(d["noise"][i:i + n]),
                "latent": torch.from_numpy(d["latent"][i:i + n]),
                "drop": torch.from_numpy(d["drop"][i:i + n])}

    trainer.draw = draw
    return {"image": torch.from_numpy(d["image"]),
            "label": torch.from_numpy(d["label"]).long(),
            "pixels": torch.from_numpy(d["pixels"])}


def _jax_loss_and_grad(cfg, jmodel, jax_teacher):
    diffusion = jc.GaussianDiffusion(
        schedule=jc.make_schedule(jc.get_named_beta_schedule("cosine", 1000)),
        model_mean_type=jc.ModelMeanType.EPSILON, weight_type="lambda",
        gamma=cfg.gamma, learn_align=True, align_type=cfg.align_type)

    def loss_fn(p, d):
        features = jax_get_feature(cfg.enc_type, jnp.asarray(d["pixels"]), jax_teacher)
        mean, std = jnp.split(jnp.asarray(d["image"]), 2, axis=-1)
        x = (mean + std * jnp.asarray(d["latent"])) * cfg.latent_scale

        def model_fn(xt, t, **kw):
            return jmodel.apply({"params": p}, xt, t, train=True,
                                force_drop_ids=jnp.asarray(d["drop"]), **kw)

        terms = diffusion.training_losses(
            model_fn, x, jnp.asarray(d["t"]), jnp.asarray(d["noise"]), features=features,
            model_kwargs={"y": jnp.asarray(d["label"])})
        return jnp.mean(terms["loss"]), jnp.mean(terms["align"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_trainer(cfg, params, teacher):
    model = DiT(**DIT)
    diffusion = tc.GaussianDiffusion(
        schedule=tc.make_schedule(tc.get_named_beta_schedule("cosine", 1000)),
        model_mean_type=tc.ModelMeanType.EPSILON, weight_type="lambda",
        gamma=cfg.gamma, learn_align=True, align_type=cfg.align_type)
    trainer = Trainer(cfg, model, diffusion, encoder_fn=teacher)
    state = trainer.init_state()
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    conv = flax_train_state_to_torch(params, ema, opt_state)
    with torch.no_grad():
        for k in state.params:
            state.params[k].copy_(conv["params"][k])
            state.ema[k].copy_(conv["ema"][k])
    return trainer, state, ema, opt_state


def test_repa_train_step_matches_jax():
    """One step: the loss and the align term of the teacher's features on
    the stored pixels, then the updated params and EMA after the fused
    AdamW+EMA, against the JAX package's on the same state and draws."""
    cfg = _cfg()
    jmodel, params = _jax_dit()
    jax_teacher, teacher = _teachers()
    trainer, state, ema, opt_state = _port_trainer(cfg, params, teacher)
    d = _draws(seed=6)
    batch = _feed(trainer, d)
    (loss, align), grads = _jax_loss_and_grad(cfg, jmodel, jax_teacher)(params, d)
    g = flax_dit_to_torch(jax.tree_util.tree_map(np.asarray, grads))
    resolved = {k: np.abs(v.numpy()) > 1e-4 * np.abs(v.numpy()).max() + 1e-7
                for k, v in g.items()}
    assert any(resolved[k].any() for k in resolved if k.startswith("projectors."))
    state, metrics = trainer.step(state, batch)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)
    assert float(metrics["align"]) == pytest.approx(float(align), rel=1e-5)
    params, ema, opt_state = fused_adamw_ema(
        params, grads, opt_state, ema, lr_fn=jax_trainer.warmup_cosine_lr(cfg),
        b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
        weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
    want = flax_train_state_to_torch(params, ema, opt_state)
    max_move = cfg.lr * (1 + cfg.weight_decay)
    for k in state.params:
        for mine, theirs in ((state.params[k].detach(), want["params"][k]),
                             (state.ema[k], want["ema"][k])):
            diff = np.abs(mine.numpy() - theirs.numpy())
            assert diff[resolved[k]].max(initial=0) <= 2e-6, k
            assert diff.max() <= max_move, k


def test_teacher_runs_per_micro_batch():
    """Under grad accumulation the teacher sees each micro-batch's pixels
    once; features in the batch skip it; a latent batch without pixels is
    refused, and a pixel batch without them feeds the teacher its images
    mapped to [0, 255]."""
    cfg = _cfg(grad_accumulation=2, batch_size=4)
    _, teacher = _teachers()
    seen = []

    def recording(x):
        seen.append(x.shape[0])
        return teacher(x)

    trainer = Trainer(cfg, DiT(**DIT), tc.GaussianDiffusion(
        schedule=tc.make_schedule(tc.get_named_beta_schedule("cosine", 1000)),
        weight_type="lambda", gamma=0.5, learn_align=True), encoder_fn=recording)
    state = trainer.init_state()
    d = _draws(seed=7, n=4)
    state, metrics = trainer.step(state, _feed(trainer, d))
    assert seen == [2, 2] and np.isfinite(float(metrics["align"]))
    halves = [get_feature(cfg.enc_type, torch.from_numpy(d["pixels"][i:i + 2]), teacher)
              for i in (0, 2)]
    batch = _feed(trainer, d)
    assert all(torch.equal(trainer.features({k: v[i:i + 2] for k, v in batch.items()},
                                            None), h) for i, h in zip((0, 2), halves))
    seen.clear()
    feats = torch.zeros(4, 16, 32)
    assert trainer.features({"features": feats}, None) is feats and seen == []
    with pytest.raises(ValueError, match="needs teacher pixels"):
        trainer.features({"image": batch["image"]}, batch["image"])
    images = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (2, 64, 64, 3))
                              .astype(np.float32))
    got = trainer.features({"image": images}, images)
    assert torch.equal(got, get_feature(cfg.enc_type, (images + 1.0) * 127.5, teacher))
