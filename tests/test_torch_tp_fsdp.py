"""Tensor parallelism and FSDP in the port (vaw_torch/parallel/partition.py,
the Trainer under a mesh, layout-free checkpoints): the TP rule census
against JAX's for DiT, U-ViT and ViT, the loud failure of a renamed
module, the head-aligned split of a DiT block at tp 2 and 4 against the
whole block, and two train steps with grad_accumulation 2 on 4 gloo CPU
ranks under dp, dp x tp and dp x tp x fsdp against the port's one-rank
step on the global batch and JAX's step on its ('data', 'model') mesh
with FSDP shardings, from one state and the same draws; then
checkpoints written under one layout and read under another.

Tolerances, those of tests/test_torch_train.py for f32: losses within
1e-5 relative; params and EMA within 2e-6 wherever the JAX step's
gradient is resolved (above 1e-4 of the leaf's max|g| + 1e-7), elsewhere
within Adam's largest move (2 lr (1 + weight decay) over two steps); the
head split within 1e-5 of the block's max|out| (forward) and 1e-4 of the
leaf's max|g| (gradients)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_dit import randomize
from _torch_ranks import run_ranks
from vaw_torch.models.convert import flax_dit_to_torch, flax_train_state_to_torch
from vaw_torch.models.dit import DiT, DiTBlock
from vaw_torch.models.mmdit import MMDiT
from vaw_torch.models.uvit import UViT
from vaw_torch.models.vit import ViT
from vaw_torch.parallel.partition import (
    assert_tp_rules_applied,
    tp_rule_census,
    tp_split_dit_block,
    tp_split_dit_block_forward,
)
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.core import GaussianDiffusion as JaxDiffusion
from vaw_tpu.core import ModelMeanType as JaxMeanType
from vaw_tpu.core import get_named_beta_schedule, make_schedule
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.models.mmdit import MMDiT as JaxMMDiT
from vaw_tpu.models.uvit import UViT as JaxUViT
from vaw_tpu.models.vit import ViT as JaxViT
from vaw_tpu.parallel.mesh import make_mesh
from vaw_tpu.parallel.partition import fsdp_param_shardings
from vaw_tpu.parallel.partition import tp_rule_census as jax_census
from vaw_tpu.train import trainer as jax_trainer
from vaw_tpu.train.fused_opt import fused_adamw_ema

X = jnp.zeros((1, 8, 8, 4))
T = jnp.zeros((1,))
Y = jnp.zeros((1,), jnp.int32)


@pytest.mark.parametrize("family", ["DiT", "U-ViT", "ViT", "MM-DiT"])
def test_tp_census_matches_jax(family):
    small = dict(image_size=8, patch_size=2, in_channels=4, num_classes=10)
    if family == "MM-DiT":
        # No rule names its layers in either package: both refuse TP loudly.
        jm = JaxMMDiT(**small, hidden_size=64, depth=2, num_heads=2)
        pm = MMDiT(**small, hidden_size=64, depth=2, num_heads=2)
        params = jm.init(jax.random.key(0), X, T, Y)["params"]
        assert not jax_census(params)[0] and not tp_rule_census(pm)[0]
        with pytest.raises(ValueError, match="silently replicate"):
            assert_tp_rules_applied(pm, 2, verbose=False)
        return
    if family == "DiT":
        jm = JaxDiT(**small, hidden_size=32, depth=2, num_heads=2)
        pm = DiT(**small, hidden_size=32, depth=2, num_heads=2)
    elif family == "U-ViT":
        jm = JaxUViT(**small, embed_dim=32, depth=3, num_heads=2)
        pm = UViT(**small, embed_dim=32, depth=3, num_heads=2)
    else:
        jm = JaxViT(**small, embed_dim=32, depth=2, num_heads=2)
        pm = ViT(**small, embed_dim=32, depth=2, num_heads=2)
    params = jm.init(jax.random.key(0), X, T, Y)["params"]
    want, _ = jax_census(params)
    got, unmatched = tp_rule_census(pm)
    assert len(got) == len(want) > 0, (got, want)
    assert not any("embed" in n for n in got) and unmatched


def test_renamed_module_fails_fast():
    net = torch.nn.Module()
    net.renamed = torch.nn.Linear(4, 4)
    assert_tp_rules_applied(net, 1, verbose=False)  # no TP, no check
    with pytest.raises(ValueError, match="silently replicate"):
        assert_tp_rules_applied(net, 2, verbose=False)


@pytest.mark.parametrize("tp", [2, 4])
def test_head_split_block_equals_the_block(tp):
    torch.manual_seed(tp)
    block = DiTBlock(64, 4)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(2, 16, 64, requires_grad=True)
    c = torch.randn(2, 64)
    g = torch.randn(2, 16, 64)
    ref = block(x, c)
    (ref * g).sum().backward()
    shards = tp_split_dit_block(block, tp)
    xs = x.detach().clone().requires_grad_()
    out = tp_split_dit_block_forward(shards, xs, c)
    (out * g).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=0,
                               atol=1e-5 * ref.abs().max().item())
    np.testing.assert_allclose(xs.grad.numpy(), x.grad.numpy(), rtol=0,
                               atol=1e-4 * x.grad.abs().max().item())
    # each shard's fc1 gradient is its rows of the whole block's
    for r, s in enumerate(shards):
        want = block.mlp.fc1.weight.grad.chunk(tp)[r]
        np.testing.assert_allclose(s.mlp.fc1.weight.grad.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("tp", [2, 4])
def test_vit_split_over_ranks_equals_the_vit(tp, tmp_path):
    """The packed (general-kernel) entry under TP: a ViT's qkv split
    head-aligned over `tp` gloo ranks, each rank on its heads, against the
    whole ViT: output within 1e-5 of max|out|, gradients (gathered, qkv
    rows back in reference order) within 1e-4 of the leaf's max|g|."""
    spec = dict(image_size=8, patch_size=2, in_channels=4, num_classes=10,
                embed_dim=64, depth=2, num_heads=4)
    torch.manual_seed(tp)
    model = ViT(**spec)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(tp)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = rs.rand(2).astype(np.float32) * 100
    y = np.array([1, 7], np.int32)
    g = rs.randn(2, 8, 8, 4).astype(np.float32)
    out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    (out * torch.from_numpy(g)).sum().backward()
    got = run_ranks("_torch_parallel_workers:vit_tensor_parallel", tp, tmp_path,
                    spec, sd, x, t, y, g)
    ref = out.detach().numpy()
    for r in got:
        assert r["heads"] == 4 // tp
        np.testing.assert_allclose(r["out"], ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    for k, p in model.named_parameters():
        want = p.grad.numpy()
        np.testing.assert_allclose(got[0]["grads"][k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-7, err_msg=k)


# ------------------------------------------------------------ train steps

SPEC = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2,
            num_heads=4, num_classes=10, class_dropout_prob=0.1)
CFG = dict(model="DiT-S", image_size=8, patch_size=2, in_chans=4, num_classes=10,
           class_cond=True, drop_label_prob=0.1, batch_size=8, grad_accumulation=2,
           weight_type="lambda", mean_type="EPSILON", path_type="cosine", amp=False,
           lr=1e-3, betas=(0.9, 0.95), weight_decay=0.01, ema_decay=0.9,
           total_steps=10, cosine_decay=True, seed=0)
STEPS, ACCUM, MICRO = 2, 2, 8


def _data():
    rng = np.random.default_rng(5)
    batches, draws = [], []
    for _ in range(STEPS):
        batches.append({"image": rng.standard_normal((ACCUM * MICRO, 8, 8, 4)).astype(np.float32),
                        "label": rng.integers(0, 10, ACCUM * MICRO).astype(np.int32)})
        draws.append([{"t": rng.integers(0, 1000, MICRO).astype(np.int32),
                       "noise": rng.standard_normal((MICRO, 8, 8, 4)).astype(np.float32),
                       "drop": (rng.random(MICRO) < 0.3).astype(np.int32)}
                      for _ in range(ACCUM)])
    return batches, draws


@pytest.fixture(scope="module")
def jax_run():
    """JAX's two steps on a 2 x 2 ('data', 'model') mesh with FSDP
    shardings: per micro-batch value_and_grad, the mean, the fused AdamW +
    EMA. -> (initial torch state dict, losses, resolved-grad masks, the
    final params and EMA under the port's names)."""
    cfg = TrainConfig(**CFG)
    model = JaxDiT(**SPEC)
    params = randomize(model.init(jax.random.key(0), X, T, Y)["params"], seed=2)
    sd = {k: v.numpy() for k, v in flax_dit_to_torch(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    mesh = make_mesh(data_axis=2, model_axis=2, devices=jax.devices()[:4])
    params = jax.device_put(params, fsdp_param_shardings(mesh, params))
    diffusion = JaxDiffusion(schedule=make_schedule(get_named_beta_schedule("cosine", 1000)),
                             model_mean_type=JaxMeanType.EPSILON, weight_type="lambda")

    def loss_fn(p, image, label, d):
        def model_fn(xt, t, **kw):
            return model.apply({"params": p}, xt, t, train=True,
                               force_drop_ids=d["drop"], **kw)
        terms = diffusion.training_losses(model_fn, image, d["t"], d["noise"],
                                          model_kwargs={"y": label})
        return jnp.mean(terms["loss"])

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt_state = jax_trainer.make_optimizer(cfg).init(params)
    batches, draws = _data()
    losses, masks = [], None
    for batch, step_draws in zip(batches, draws):
        total, grads = 0.0, None
        for i, d in enumerate(step_draws):
            rows = slice(i * MICRO, (i + 1) * MICRO)
            loss, g = value_and_grad(params, batch["image"][rows], batch["label"][rows],
                                     {k: jnp.asarray(v) for k, v in d.items()})
            total += float(loss)
            grads = g if grads is None else jax.tree_util.tree_map(jnp.add, grads, g)
        grads = jax.tree_util.tree_map(lambda a: a / ACCUM, grads)
        losses.append(total / ACCUM)
        g = flax_dit_to_torch(jax.tree_util.tree_map(np.asarray, grads))
        mask = {k: np.abs(v.numpy()) > 1e-4 * np.abs(v.numpy()).max() + 1e-7
                for k, v in g.items()}
        masks = mask if masks is None else {k: masks[k] & mask[k] for k in mask}
        params, ema, opt_state = fused_adamw_ema(
            params, grads, opt_state, ema, lr_fn=jax_trainer.warmup_cosine_lr(cfg),
            b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
            weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
    final = flax_train_state_to_torch(jax.tree_util.tree_map(np.asarray, params),
                                      jax.tree_util.tree_map(np.asarray, ema), opt_state)
    return sd, losses, masks, {k: {n: v.numpy() for n, v in final[k].items()}
                               for k in ("params", "ema")}


@pytest.fixture(scope="module")
def one_rank(jax_run, tmp_path_factory):
    """The port's one-rank steps on the global batches, in this process."""
    from _torch_parallel_workers import train_steps

    sd = jax_run[0]
    batches, draws = _data()
    return train_steps(CFG, SPEC, sd, batches, draws, None,
                       save_dir=str(tmp_path_factory.mktemp("one_rank")))


def _close_states(got, want, masks):
    max_move = STEPS * CFG["lr"] * (1 + CFG["weight_decay"])
    for tree in ("params", "ema"):
        assert set(got[tree]) == set(want[tree])
        for k, w in want[tree].items():
            diff = np.abs(got[tree][k] - w)
            assert diff[masks[k]].max(initial=0) <= 2e-6, (tree, k, diff[masks[k]].max())
            assert diff.max() <= max_move, (tree, k)


def test_one_rank_step_matches_jax(jax_run, one_rank):
    _, losses, masks, final = jax_run
    np.testing.assert_allclose(one_rank["losses"], losses, rtol=1e-5)
    _close_states(one_rank, final, masks)


@pytest.mark.parametrize("layout", [
    {"data_axis": 4, "model_axis": 1, "fsdp": False},
    {"data_axis": 2, "model_axis": 2, "fsdp": False},
    {"data_axis": 2, "model_axis": 2, "fsdp": True},
], ids=["dp", "dp_tp", "dp_tp_fsdp"])
def test_four_rank_steps_match_one_rank_and_jax(layout, jax_run, one_rank, tmp_path):
    sd, losses, masks, final = jax_run
    batches, draws = _data()
    out = run_ranks("_torch_parallel_workers:train_steps", 4, tmp_path, CFG, SPEC, sd,
                    batches, draws, layout)
    for r in out:  # every rank holds the same global metrics and state
        np.testing.assert_allclose(r["losses"], out[0]["losses"], rtol=0, atol=0)
    got = out[0]
    assert got["step"] == got["count"] == STEPS
    np.testing.assert_allclose(got["losses"], one_rank["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], one_rank["norms"], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close_states(got, one_rank, masks)
    _close_states(got, final, masks)
    census = got["census"]
    if layout["fsdp"]:
        assert not census["replicated"]  # fully_shard: every leaf split
    elif layout["model_axis"] > 1:
        # qkv, fc1 (weight and bias), proj and fc2 (weight) of each block
        assert len(census["sharded"]) == 6 * SPEC["depth"]
    else:
        assert not census["sharded"]


def test_resampler_folds_every_rank_in_order(jax_run, tmp_path, tmp_path_factory):
    """Under --time_sampler loss-second-moment the history after two steps
    on 4 data ranks is the one-rank run's: every rank's (t, loss) folded in
    the global batch's row order."""
    from _torch_parallel_workers import train_steps

    cfg = dict(CFG, time_sampler="loss-second-moment")
    sd = jax_run[0]
    batches, draws = _data()
    one = train_steps(cfg, SPEC, sd, batches, draws, None)
    four = run_ranks("_torch_parallel_workers:train_steps", 4, tmp_path, cfg, SPEC, sd,
                     batches, draws, {"data_axis": 4, "model_axis": 1, "fsdp": False})
    assert one["resampler"]["loss_counts"].sum() == STEPS * ACCUM * MICRO
    np.testing.assert_array_equal(four[0]["resampler"]["loss_counts"],
                                  one["resampler"]["loss_counts"])
    np.testing.assert_allclose(four[0]["resampler"]["loss_history"],
                               one["resampler"]["loss_history"], rtol=1e-5, atol=1e-7)


def _equal_states(a, b):
    for tree in ("params", "ema", "mu", "nu"):
        assert set(a[tree]) == set(b[tree])
        for k in a[tree]:
            np.testing.assert_array_equal(a[tree][k], b[tree][k], err_msg=f"{tree} {k}")


FSDP_TP = {"data_axis": 2, "model_axis": 2, "fsdp": True}


def test_checkpoint_from_four_ranks_loads_at_one(jax_run, tmp_path):
    """dp x tp x fsdp writes (rank 0, full tensors, reference layout); one
    rank reads the file back to the same state."""
    sd = jax_run[0]
    batches, draws = _data()
    out = run_ranks("_torch_parallel_workers:train_steps", 4, tmp_path, CFG, SPEC, sd,
                    batches, draws, FSDP_TP, str(tmp_path / "logs"))
    payload = torch.load(out[0]["path"], weights_only=True)
    assert payload["step"] == STEPS and set(payload["params"]) == set(sd)
    assert all(v.shape == sd[k].shape for k, v in payload["params"].items())
    from _torch_parallel_workers import train_steps

    back = train_steps(CFG, SPEC, sd, [], [], None, load=out[0]["path"])
    _equal_states(back, out[0])


def test_checkpoint_from_one_rank_loads_at_four(jax_run, one_rank, tmp_path):
    out = run_ranks("_torch_parallel_workers:train_steps", 4, tmp_path, CFG, SPEC,
                    jax_run[0], [], [], FSDP_TP, None, one_rank["path"])
    for r in out:
        _equal_states(r, one_rank)
