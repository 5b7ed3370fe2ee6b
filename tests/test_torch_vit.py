"""Parity of the port's ViT (vaw_torch/models/vit.py) with the JAX package's
(vaw_tpu/models/vit.py) on the same weights and inputs, its Flax -> torch
converter, remat of its blocks and the flow-mode time token (ROADMAP C8).

The tiny ViT: embed 64, depth 3, 4 heads of 16, 8x8x4 images, patch 2,
10 classes, so T = 16 patches + a time token + a class token = 18 (17
unconditional). Weights are made by the Flax model's init and replaced by
seeded numpy noise, then cross through vaw_torch.models.convert.
flax_vit_to_torch. On the CPU both packages compute the attention in plain
f32 (the JAX package routes T < 256 away from its Pallas kernel; the port's
kernel entry runs its plain version on a CPU tensor).

Tolerance: the f32 forward within atol 1e-4 (tests/test_torch_dit.py's),
with outputs of order 1; the port's bf16 compute against the f32 JAX
forward within 3e-2 of max|out|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models import build_model, cast_for_compute
from vaw_torch.models.convert import flax_to_torch, flax_vit_to_torch
from vaw_torch.models.vit import ViT, _rel_pos_index, vit_forward_with_cfg
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.models import vit as jvit
from vaw_tpu.models.vit import ViT as JaxViT

TINY = dict(image_size=8, patch_size=2, in_channels=4, embed_dim=64, depth=3,
            num_heads=4, num_classes=10, drop_label_prob=0.1)
ATOL = 1e-4


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf: kernels ~ 1/sqrt(fan_in),
    LayerNorm scales ~ 1 + 0.1 N, layer scales ~ 0.5 + 0.1 N, tables and
    pos_embed ~ 0.3, biases ~ 0.05."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        if name.startswith("gamma"):
            return (0.5 + 0.1 * z).astype(np.float32)
        std = 0.3 if name in ("embedding", "pos_embed",
                              "relative_position_bias_table") else 0.05
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(seed=0, **overrides):
    kw = dict(TINY, **overrides)
    jmodel = JaxViT(**kw)
    y = jnp.zeros((2,), jnp.int32) if kw["num_classes"] > 0 else None
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, 8, 8, 4)),
                         jnp.zeros((2,)), y)["params"]
    params = _randomize(params, seed)
    tmodel = ViT(**kw)
    tmodel.load_state_dict(flax_vit_to_torch(params), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(n=3, seed=1, t_high=999.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 4)).astype(np.float32)
    t = rng.uniform(0, t_high, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, t, y


def _run_both(jmodel, params, tmodel, x, t, y, drop=None):
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                        None if y is None else jnp.asarray(y),
                        force_drop_ids=None if drop is None else jnp.asarray(drop))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                     None if y is None else torch.from_numpy(y).long(),
                     force_drop_ids=None if drop is None else torch.from_numpy(drop))
    return got, np.asarray(want)


CASES = {
    "conditional": {},
    "unconditional": dict(num_classes=0),
    "rel_pos_bias": dict(use_shared_rel_pos_bias=True),
    "rel_pos_bias_unconditional": dict(use_shared_rel_pos_bias=True, num_classes=0),
    "init_values": dict(init_values=0.1),
    "qkv_bias_conv_last_norm": dict(qkv_bias=True, use_conv_last=True,
                                    use_mean_pooling=False),
    "learn_sigma": dict(learn_sigma=True),
    "force_drop_ids": {},
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_vit_forward_f32_matches(case):
    jmodel, params, tmodel = _pair(**CASES[case])
    x, t, y = _inputs()
    if CASES[case].get("num_classes") == 0:
        y = None
    drop = np.array([1, 0, 1], np.int32) if case == "force_drop_ids" else None
    got, want = _run_both(jmodel, params, tmodel, x, t, y, drop)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_unpacked_route_matches(monkeypatch):
    """VAW_PACKED_QKV=0 sends the attention through multi_head_attention on
    q, k and v, in both packages."""
    monkeypatch.setenv("VAW_PACKED_QKV", "0")
    jmodel, params, tmodel = _pair(seed=2)
    x, t, y = _inputs(seed=3)
    got, want = _run_both(jmodel, params, tmodel, x, t, y)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_rel_pos_index_bit_equal():
    for window in ((4, 4), (3, 5)):
        for extra in (0, 1, 2):
            got, n_got = _rel_pos_index(window, extra)
            want, n_want = jvit._rel_pos_index(window, extra)
            assert n_got == n_want
            np.testing.assert_array_equal(got, want)


def test_force_drop_ids_select_the_null_row():
    _, _, tmodel = _pair()
    x, t, y = _inputs()
    xs, ts = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        dropped = tmodel(xs, ts, torch.from_numpy(y).long(),
                         force_drop_ids=torch.ones(3, dtype=torch.int32))
        null = tmodel(xs, ts, torch.full((3,), 10))
    torch.testing.assert_close(dropped, null, rtol=0, atol=0)
    assert tmodel.has_null_label and not _pair(drop_label_prob=0.0)[2].has_null_label


def test_label_dropout_draws_from_the_generator():
    _, _, tmodel = _pair(drop_label_prob=0.5)
    x, t, _ = _inputs(n=64, seed=4)
    y = torch.arange(64) % 10
    args = (torch.from_numpy(x), torch.from_numpy(t), y)
    with torch.no_grad():
        a = tmodel(*args, train=True, generator=torch.Generator().manual_seed(1))
        b = tmodel(*args, train=True, generator=torch.Generator().manual_seed(1))
        clean = tmodel(*args)
        null = tmodel(args[0], args[1], torch.full((64,), 10))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    dropped = [(a[i] == null[i]).all().item() for i in range(64)]
    kept = [(a[i] == clean[i]).all().item() for i in range(64)]
    assert all(d or k for d, k in zip(dropped, kept)) and 10 < sum(dropped) < 54


def test_cfg_helper_matches():
    jmodel, params, tmodel = _pair(seed=5)
    x, t, y = _inputs(n=4, seed=6)
    y[2:] = 10  # the second half carries the null label
    want = jvit.vit_forward_with_cfg(jmodel, {"params": params}, jnp.asarray(x),
                                     jnp.asarray(t), jnp.asarray(y),
                                     classifier_free_scale=1.7)
    with torch.no_grad():
        got = vit_forward_with_cfg(tmodel, torch.from_numpy(x), torch.from_numpy(t),
                                   torch.from_numpy(y).long(), 1.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    torch.testing.assert_close(got[:2], got[2:], rtol=0, atol=0)


def test_flow_time_reads_row_zero():
    """ROADMAP C8: t in [0, 1) truncates to index 0 in both packages, so the
    output does not depend on t; t = 1 reads row 1."""
    jmodel, params, tmodel = _pair(seed=7)
    x, _, y = _inputs(seed=8)
    outs = []
    for t in (0.0, 0.3, 0.999, 1.0):
        tt = np.full((3,), t, np.float32)
        got, want = _run_both(jmodel, params, tmodel, x, tt, y)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        outs.append(got)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    torch.testing.assert_close(outs[0], outs[2], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[3])


def test_tiny_vit_bf16_compute_near_f32_jax():
    jmodel, params, tmodel = _pair(seed=9, init_values=0.1)
    x, t, y = _inputs(seed=10)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(y)))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    tmodel.compute_dtype = torch.bfloat16
    with torch.no_grad():
        got = tmodel(*args)
        sampler = cast_for_compute(tmodel, torch.bfloat16)
        assert sampler.linear_projection.weight.dtype == torch.float32
        assert sampler.blocks[0].gamma_1.dtype == torch.float32
        assert sampler.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
        again = sampler(*args)
    scale = np.abs(want).max()
    for out in (got, again):
        assert out.dtype == torch.float32
        assert np.abs(out.numpy() - want).max() / scale <= 3e-2


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_rematted_blocks_convert_and_match(policy):
    """A rematted Flax ViT (CheckpointViTBlock_i) converts; the port's
    rematted model gives the same output and the same gradients as without
    remat."""
    jmodel, params, _ = _pair(seed=11, use_checkpoint=True, remat_policy=policy)
    assert any(str(k).startswith("CheckpointViTBlock") for k in params)
    tmodel = ViT(**TINY, use_checkpoint=True, remat_policy=policy)
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    plain = ViT(**TINY)
    plain.load_state_dict(flax_to_torch(params), strict=True)
    x, t, y = _inputs(seed=12)
    got, want = _run_both(jmodel, params, tmodel.eval(), x, t, y)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    grads = []
    for model in (tmodel.train(), plain.train()):
        model.zero_grad()
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
        out.square().sum().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[1]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-5, atol=1e-6)


def test_converter_refuses_unmatched_and_missing():
    _, params, _ = _pair()
    extra = dict(params)
    extra["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no conversion rule"):
        flax_vit_to_torch(extra)
    short = {k: v for k, v in params.items() if k != "Dense_0"}
    with pytest.raises(ValueError, match="lack"):
        flax_vit_to_torch(short)


@pytest.mark.parametrize("name,width,depth,heads", [
    ("ViT-S", 512, 13, 4), ("ViT-B", 768, 12, 12), ("ViT-L", 1024, 21, 16),
    ("ViT-XL", 1152, 28, 16)])
def test_registry_builds_the_sizes(name, width, depth, heads):
    cfg = TrainConfig(model=name, image_size=32, patch_size=2, in_chans=4,
                      num_classes=1000, class_cond=True, drop_label_prob=0.1)
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    assert isinstance(model, ViT) and len(model.blocks) == depth
    assert model.pos_embed.shape == (1, 258, width)
    assert model.blocks[0].attn.num_heads == heads and model.has_null_label
