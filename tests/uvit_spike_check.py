#!/usr/bin/env python3
"""One-off check: does the JAX package's U-ViT train step show the loss
spike that the port's shows in its first steps on the card (ROADMAP C3)?

    JAX_PLATFORMS=cpu VAW_PLATFORM=cpu python tests/uvit_spike_check.py
    JAX_PLATFORMS=cpu VAW_PLATFORM=cpu python tests/uvit_spike_check.py \
        --embed_dim 64 --depth 3 --num_heads 4     # a narrow model, seconds

Both packages run on the CPU (the port on the card with --device cuda,
through its attention kernels) from one initial train state (the JAX init,
converted with flax_train_state_to_torch) with the card's recipe: the
flags of chip_smoke.py's U-ViT-L/2 training phase (cosine, EPSILON,
lambda, label dropout 0.1, AdamW (0.9, 0.95), lr 1e-4, no warm-up, bf16
compute over f32 masters, fused AdamW + EMA). Each step both get the same
Gaussian batch (the port's GaussianDataset), t, noise and label-drop ids:
the JAX side draws them as its trainer does (fold_in of the step's key),
and the port's Trainer.draw is replaced to return them. It prints both
losses per step and their relative difference.

Not a tier-1 test: it takes minutes, and U-ViT-L/2 at full depth (--depth
21, the default) holds two train states of 287M parameters, one in each
package; --depth 5 keeps the full width at a quarter of that.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import vaw_torch.cli.main as port_cli  # noqa: E402
from vaw_torch.data.datasets import GaussianDataset  # noqa: E402
from vaw_torch.models import uvit as port_uvit  # noqa: E402
from vaw_torch.models.convert import flax_train_state_to_torch  # noqa: E402
from vaw_torch.train import Trainer  # noqa: E402
from vaw_tpu.core import GaussianDiffusion as JaxDiffusion  # noqa: E402
from vaw_tpu.core import ModelMeanType as JaxMeanType  # noqa: E402
from vaw_tpu.core import get_named_beta_schedule, make_schedule  # noqa: E402
from vaw_tpu.models import uvit as jax_uvit  # noqa: E402
from vaw_tpu.train import trainer as jax_trainer  # noqa: E402
from vaw_tpu.train.fused_opt import fused_adamw_ema  # noqa: E402

# chip_smoke.py's U-ViT-L/2 training flags (MODEL_ARGS + RECIPE_ARGS).
CARD_ARGS = ["--model", "U-ViT-L", "--image_size", "32", "--patch_size", "2",
             "--in_chans", "4", "--num_classes", "1000", "--class_cond", "True",
             "--drop_label_prob", "0.1", "--amp", "True", "--dataset", "Gaussian",
             "--weight_type", "lambda", "--mean_type", "EPSILON", "--path_type",
             "cosine", "--betas", "0.9", "0.95", "--total_steps", "30",
             "--eval", "False"]


class _DropIds(nn.Module):
    """The U-ViT's own label-drop draw (vaw_tpu/models/uvit.py:110-114) at
    the root scope, where the model calls make_rng."""
    prob: float

    @nn.compact
    def __call__(self, n):
        return jax.random.uniform(self.make_rng("label_dropout"), (n,)) < self.prob


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--embed_dim", type=int, default=1024)
    p.add_argument("--depth", type=int, default=21)
    p.add_argument("--num_heads", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cpu", help="the port's device")
    args = p.parse_args(argv)

    cfg = port_cli.parse_args(CARD_ARGS + ["--batch_size", str(args.batch_size)])
    assert cfg.warmup_steps == 0 and cfg.amp
    n = args.batch_size
    width = dict(embed_dim=args.embed_dim, depth=args.depth, num_heads=args.num_heads)
    common = dict(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                  class_dropout_prob=cfg.drop_label_prob, mlp_ratio=4, **width)

    jmodel = jax_uvit.UViT(**common, dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.key(args.seed), jnp.zeros((1, 32, 32, 4)),
                         jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    diffusion = JaxDiffusion(schedule=make_schedule(get_named_beta_schedule("cosine", 1000)),
                             model_mean_type=JaxMeanType.EPSILON, weight_type="lambda")

    def loss_fn(p_, x, t, noise, y, key):
        def model_fn(xt, tt, **kw):  # as the JAX trainer calls it (trainer.py:310-317)
            return jmodel.apply({"params": p_}, xt, tt, train=True,
                                rngs={"label_dropout": key}, **kw)
        terms = diffusion.training_losses(model_fn, x, t, noise, model_kwargs={"y": y})
        return jnp.mean(terms["loss"])

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    @jax.jit
    def update(params, grads, opt_state, ema):
        return fused_adamw_ema(params, grads, opt_state, ema,
                               lr_fn=jax_trainer.warmup_cosine_lr(cfg), b1=cfg.betas[0],
                               b2=cfg.betas[1], eps=cfg.eps, weight_decay=cfg.weight_decay,
                               ema_decay=cfg.ema_decay)

    model = port_uvit.UViT(**common, compute_dtype=cfg.compute_dtype).to(args.device)
    trainer = Trainer(cfg, model, port_cli.build_diffusion(cfg))
    state = trainer.init_state()
    conv = flax_train_state_to_torch(params, ema, opt_state)
    with torch.no_grad():
        for k in state.params:
            state.params[k].copy_(conv["params"][k])
            state.ema[k].copy_(conv["ema"][k])
            state.mu[k].copy_(conv["opt"]["mu"][k])
            state.nu[k].copy_(conv["opt"]["nu"][k])
    state.count = conv["opt"]["count"]

    data = GaussianDataset(image_size=32, channels=4, num_classes=1000, seed=args.seed)
    base = jax.random.key(args.seed)
    n_params = sum(v.numel() for v in state.params.values())
    print(f"U-ViT embed {args.embed_dim} depth {args.depth} heads {args.num_heads} "
          f"({n_params / 1e6:.2f}M parameters), batch {n}, lr {cfg.lr}, warm-up "
          f"{cfg.warmup_steps}, betas {cfg.betas}, weight decay {cfg.weight_decay}, "
          f"bf16 compute; JAX {jax.__version__} on {jax.devices()[0].platform}, torch "
          f"{torch.__version__} on {args.device}", flush=True)
    for step in range(args.steps):
        batch = data.get_batch(np.arange(step * n, (step + 1) * n))
        rng = jax.random.fold_in(base, step)  # as vaw_tpu's Trainer.step
        t = np.asarray(diffusion.sample_t(jax.random.fold_in(rng, 0), n))
        noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, 1),
                                             batch["image"].shape, jnp.float32))
        key = jax.random.fold_in(rng, 4)
        drop = np.asarray(_DropIds(cfg.drop_label_prob).apply(
            {}, n, rngs={"label_dropout": key})).astype(np.int32)

        t0 = time.perf_counter()
        jloss, grads = value_and_grad(params, jnp.asarray(batch["image"]), jnp.asarray(t),
                                      jnp.asarray(noise), jnp.asarray(batch["label"]), key)
        params, ema, opt_state = update(params, grads, opt_state, ema)
        jloss = float(jloss)
        t1 = time.perf_counter()
        dev = args.device
        trainer.draw = lambda b, t=t, noise=noise, drop=drop: {
            "t": torch.tensor(np.asarray(t), dtype=torch.long, device=dev),
            "noise": torch.from_numpy(noise).to(dev), "latent": None,
            "drop": torch.from_numpy(drop).to(dev)}
        state, metrics = trainer.step(state, {
            "image": torch.from_numpy(batch["image"]).to(dev),
            "label": torch.from_numpy(batch["label"]).long().to(dev)})
        ploss = float(metrics["loss"])
        t2 = time.perf_counter()
        print(f"step {step + 1}: loss JAX {jloss:.5f}, port {ploss:.5f}, relative "
              f"difference {abs(ploss - jloss) / abs(jloss):.3e}; t {list(map(int, t))}, "
              f"drop {drop.tolist()} ({t1 - t0:.1f} s JAX, {t2 - t1:.1f} s port)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
