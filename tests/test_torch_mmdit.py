"""Parity of the port's MM-DiT (vaw_torch/models/mmdit.py) with the JAX
package's (vaw_tpu/models/mmdit.py) on the same weights and inputs, its
REPA projector tap, and its Flax -> torch converter.

The tiny MM-DiT: hidden 64, depth 3 (the last block's context stream
pre-only), 2 heads of 32, 8x8x4 images, patch 2 (16 image tokens), 10
classes. Weights are made by the Flax model's init and replaced by seeded
numpy noise (the zero-initialised adaLN modulations and head included), then
cross through vaw_torch.models.convert.flax_mmdit_to_torch. Both packages
compute the joint attention in plain f32 on the CPU.

Tolerance: the f32 forward within atol 1e-4 (tests/test_torch_dit.py's),
with outputs of order 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models import build_model, cast_for_compute
from vaw_torch.models.convert import flax_mmdit_to_torch, flax_to_torch
from vaw_torch.models.mmdit import MMDiT
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.models.mmdit import MMDiT as JaxMMDiT

TINY = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=3,
            num_heads=2, num_classes=10, class_dropout_prob=0.1, context_dim=24)
ATOL = 1e-4


def _randomize(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        std = 0.3 if name in ("embedding", "register") else 0.05
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(seed=0, y_kind="label", context=False, **overrides):
    kw = dict(TINY, **overrides)
    jmodel = JaxMMDiT(**kw)
    x0, t0 = jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,))
    y0 = {"label": jnp.zeros((2,), jnp.int32), "none": None,
          "vector": jnp.zeros((2, kw.get("adm_in_channels") or 1))}[y_kind]
    ctx0 = jnp.zeros((2, 5, kw["context_dim"])) if context else None
    params = jmodel.init(jax.random.key(0), x0, t0, y0, ctx0)["params"]
    params = _randomize(params, seed)
    tmodel = MMDiT(**kw, with_context=context)
    tmodel.load_state_dict(flax_mmdit_to_torch(params), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(n=3, seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 8, 8, 4)).astype(np.float32),
            "t": rng.uniform(0, 999, n).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32),
            "vector": rng.standard_normal((n, 7)).astype(np.float32),
            "context": rng.standard_normal((n, 5, 24)).astype(np.float32)}


def _run_both(jmodel, params, tmodel, x, t, y=None, context=None, drop=None):
    want, zs = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t),
        None if y is None else jnp.asarray(y),
        None if context is None else jnp.asarray(context),
        force_drop_ids=None if drop is None else jnp.asarray(drop))
    assert zs is None
    to = (lambda a: None if a is None else torch.from_numpy(a))
    yt = None if y is None else (torch.from_numpy(y).long() if y.dtype == np.int32
                                 else torch.from_numpy(y))
    with torch.no_grad():
        got, tzs = tmodel(to(x), to(t), yt, to(context),
                          force_drop_ids=to(drop))
    assert tzs is None and got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


CASES = {
    "default": (dict(), "label", False),
    "sd3_options": (dict(qk_norm="rms", use_rmsnorm=True, use_swiglu=True,
                         scale_mod_only=True), "label", False),
    "qk_norm_ln": (dict(qk_norm="ln"), "label", False),
    "context_registers": (dict(register_length=3), "label", True),
    "adm_vector": (dict(adm_in_channels=7, num_classes=0), "vector", False),
    "unconditional": (dict(num_classes=0, context_tokens=2), "none", False),
    "learn_sigma": (dict(learn_sigma=True), "label", False),
    "force_drop_ids": (dict(), "label", False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_mmdit_forward_f32_matches(case):
    overrides, y_kind, context = CASES[case]
    jmodel, params, tmodel = _pair(y_kind=y_kind, context=context, **overrides)
    d = _inputs()
    y = {"label": d["label"], "vector": d["vector"], "none": None}[y_kind]
    drop = np.array([1, 0, 1], np.int32) if case == "force_drop_ids" else None
    got, want = _run_both(jmodel, params, tmodel, d["x"], d["t"], y,
                          d["context"] if context else None, drop)
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_last_block_context_is_pre_only():
    """The last block's context stream projects qkv only: no output
    projection, no MLP, a 2-way modulation (a 1-way one under
    scale_mod_only); every other block carries both streams whole."""
    _, params, tmodel = _pair()
    last = tmodel.joint_blocks[-1].context_block
    assert last.pre_only and last.attn.proj is None and last.mlp is None
    assert last.adaLN_modulation[1].out_features == 2 * 64
    assert "out_proj" not in params["joint_2"]["context"]
    assert "mlp" not in params["joint_2"]["context"]
    assert not tmodel.joint_blocks[1].context_block.pre_only
    sd = set(tmodel.state_dict())
    assert "joint_blocks.2.context_block.attn.proj.weight" not in sd
    assert "joint_blocks.1.context_block.attn.proj.weight" in sd
    smo = MMDiT(**TINY, scale_mod_only=True)
    assert smo.joint_blocks[-1].context_block.adaLN_modulation[1].out_features == 64
    assert smo.joint_blocks[0].x_block.adaLN_modulation[1].out_features == 4 * 64


def test_bf16_compute_near_f32_jax_and_f32_head():
    jmodel, params, tmodel = _pair(seed=3)
    d = _inputs(seed=4)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(d["x"]),
                                   jnp.asarray(d["t"]), jnp.asarray(d["label"]))[0])
    args = (torch.from_numpy(d["x"]), torch.from_numpy(d["t"]),
            torch.from_numpy(d["label"]).long())
    with torch.no_grad():
        sampler = cast_for_compute(tmodel, torch.bfloat16)
        assert sampler.final_layer.linear.weight.dtype == torch.float32
        assert sampler.joint_blocks[0].x_block.attn.qkv.weight.dtype == torch.bfloat16
        got = sampler(*args)[0]
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 3e-2


def test_rematted_tree_converts_and_matches():
    jmodel, params, _ = _pair(seed=5, use_checkpoint=True)
    tmodel = MMDiT(**TINY, use_checkpoint=True)
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    d = _inputs(seed=6)
    got, want = _run_both(jmodel, params, tmodel, d["x"], d["t"], d["label"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("z_dims", [(32,), (32, 16)], ids=["one_teacher", "two"])
def test_projector_tap_matches_jax(z_dims):
    """learn_align: the projectors after block encoder_depth (2 of 3) carried
    across by flax_mmdit_to_torch; zs is one [N, T, z] array for one teacher
    and a list for two (vaw_tpu/models/mmdit.py:366-395). encoder_depth 0
    is refused."""
    kw = dict(learn_align=True, encoder_depth=2, z_dims=z_dims, projector_dim=48)
    jmodel, params, tmodel = _pair(seed=11, **kw)
    assert {k for k in tmodel.state_dict() if k.startswith("projectors.")} == {
        f"projectors.{j}.{i}.{n}" for j in range(len(z_dims)) for i in (0, 2, 4)
        for n in ("weight", "bias")}
    d = _inputs(seed=12)
    want, want_zs = jmodel.apply({"params": params}, jnp.asarray(d["x"]),
                                 jnp.asarray(d["t"]), jnp.asarray(d["label"]))
    with torch.no_grad():
        got, got_zs = tmodel(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]),
                             torch.from_numpy(d["label"]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if len(z_dims) == 1:
        want_zs, got_zs = [want_zs], [got_zs]
    assert len(got_zs) == len(want_zs) == len(z_dims)
    for g, w, z in zip(got_zs, want_zs, z_dims):
        assert g.shape == (3, 16, z)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="encoder_depth > 0"):
        MMDiT(**TINY, learn_align=True, encoder_depth=0)


@pytest.mark.parametrize("name,hidden,depth", [("MM-DiT-S", 384, 12),
                                               ("MM-DiT-B", 768, 24),
                                               ("MM-DiT-L", 1024, 32)])
def test_registry_builds_the_sizes(name, hidden, depth):
    cfg = TrainConfig(model=name, image_size=32, patch_size=2, in_chans=4,
                      num_classes=1000, class_cond=True, drop_label_prob=0.1)
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    assert isinstance(model, MMDiT) and len(model.joint_blocks) == depth
    assert model.hidden_size == hidden and model.has_null_label
    assert model.joint_blocks[0].x_block.num_heads == depth
    assert model.pos_embed.shape == (256, hidden)
