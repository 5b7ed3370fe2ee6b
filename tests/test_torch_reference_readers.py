"""The port's readers of the reference framework's own torch state dicts
(vaw_torch/models/convert.py: reference_unet_to_torch, reference_vit_to_torch,
reference_to_torch) against the JAX package's converters of the same
layouts (vaw_tpu/models/convert.py: convert_unet, convert_vit, convert_dit,
convert_mmdit, convert_uvit).

Each reference layout is built from seeded Flax params: flax_to_torch gives
the port's state dict (as tests/test_torch_unet.py:239-257 does), which is
put in the reference's form: the UNet's qkv and proj_out as 1x1 conv1d
weights with the qkv rows in the legacy per-head interleave (the
SuperResModel's names without the port's ``unet.`` prefix); the ViT's qkv
bias as ``q_bias`` and ``v_bias`` (the reference has no k bias, so the
params' k part is zeroed first) beside the relative-position index buffer;
the DiT's and MM-DiT's frozen sin-cos ``pos_embed`` stored. Then:

- the reader gives the port's state dict back exactly, which loads with
  strict=True;
- the JAX converter of the same layout gives the Flax params exactly;
- the port's forward on the loaded weights matches the JAX forward on the
  converted params within the family's tolerance (the UNet 1e-4 of
  max|out|, tests/test_torch_unet.py; the ViT atol 1e-4,
  tests/test_torch_vit.py);
- a name the model lacks raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models import unet as port_unet
from vaw_torch.models.convert import (
    _legacy_qkv_perm,
    flax_to_torch,
    reference_to_torch,
    reference_unet_to_torch,
    reference_vit_to_torch,
)
from vaw_torch.models.dit import DiT
from vaw_torch.models.mmdit import MMDiT
from vaw_torch.models.uvit import UViT
from vaw_torch.models.vit import ViT
from vaw_tpu.models import unet as jax_unet
from vaw_tpu.models.convert import (
    convert_dit,
    convert_mmdit,
    convert_unet,
    convert_uvit,
    convert_vit,
)
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.models.mmdit import MMDiT as JaxMMDiT
from vaw_tpu.models.uvit import UViT as JaxUViT
from vaw_tpu.models.vit import ViT as JaxViT


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test (the suite runs several test processes
    side by side), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf: kernels ~ 1/sqrt(fan_in),
    norm scales ~ 1 + 0.1 N, tables ~ 0.3, biases ~ 0.05 (zero-initialised
    heads included)."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        std = 0.3 if name in ("embedding", "pos_embed", "register",
                              "relative_position_bias_table") else 0.05
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tree(got, want):
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    want = jax.tree_util.tree_leaves_with_path(want)
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


def _assert_same_state(got, model):
    want = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and torch.equal(got[k], v), k


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ------------------------------------------------------------------ UNet

UNET = dict(image_size=16, in_channels=4, model_channels=32, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2, 4), channel_mult=(1, 2, 4),
            num_classes=10, drop_label_prob=0.1)
UNET_CASES = {
    # 4 heads in the input and middle blocks, 2 in the output blocks
    "num_heads_upsample": dict(num_heads=4, num_head_channels=-1, num_heads_upsample=2),
    "num_head_channels": dict(num_head_channels=8),
}


def _unet_reference_layout(sd, model):
    """The port's UNet state dict in the reference's form: qkv rows in the
    legacy per-head interleave (each block's own heads), qkv and proj_out
    as [out, in, 1] conv1d weights."""
    out = {}
    for name, v in sd.items():
        if name.endswith(("qkv.weight", "qkv.bias")):
            heads = model.get_submodule(name.rsplit(".", 2)[0]).num_heads
            legacy = torch.empty_like(v)
            legacy[torch.from_numpy(_legacy_qkv_perm(v.shape[0] // 3, heads))] = v
            v = legacy
        if name.endswith(("qkv.weight", "proj_out.weight")):
            v = v[..., None]
        out[name] = v.clone()
    return out


def _unet_inputs(seed=1, c=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, c)).astype(np.float32),
            rng.uniform(0, 999, 2).astype(np.float32),
            rng.integers(0, 10, 2).astype(np.int32))


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_reference_unet_round_trips_and_matches_jax(case):
    kw = dict(UNET, **UNET_CASES[case])
    jmodel = jax_unet.UNetModel(**kw)
    x, t, y = _unet_inputs()
    params = _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(y))["params"], seed=len(case))
    tmodel = port_unet.UNetModel(**kw)
    own = flax_to_torch(params, model=tmodel)
    tmodel.load_state_dict(own, strict=True)
    heads = sorted({m.num_heads for m in tmodel.modules()
                    if isinstance(m, port_unet.AttentionBlock)})
    assert heads == ([2, 4] if case == "num_heads_upsample" else [8, 16])
    ref = _unet_reference_layout(own, tmodel)

    loaded = port_unet.UNetModel(**kw)
    back = reference_unet_to_torch(ref, loaded)
    _assert_same_state(back, tmodel)
    loaded.load_state_dict(back, strict=True)
    assert reference_to_torch(ref, loaded).keys() == back.keys()
    # the port's own layout passes as it is
    _assert_same_state(reference_unet_to_torch(own, loaded), tmodel)
    _assert_same_tree(convert_unet(_numpy(ref), **UNET_CASES[case]), params)

    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = loaded.eval()(torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(y).long())
    _close(got.numpy(), want, 1e-4)


def test_reference_super_res_unet_reads_without_the_unet_prefix():
    kw = dict(UNET, in_channels=7, out_channels=3, num_head_channels=8)
    jmodel = jax_unet.SuperResModel(unet=jax_unet.UNetModel(**kw))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    low = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    y = np.array([1, 3], np.int32)
    params = _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                                    low_res=jnp.asarray(low), y=jnp.asarray(y))["params"],
                        seed=4)
    tmodel = port_unet.SuperResModel(port_unet.UNetModel(**kw))
    own = flax_to_torch(params, model=tmodel)
    tmodel.load_state_dict(own, strict=True)
    inner = {k.removeprefix("unet."): v for k, v in own.items()}
    ref = _unet_reference_layout(inner, tmodel.unet)
    assert not any(k.startswith("unet.") for k in ref)

    loaded = port_unet.SuperResModel(port_unet.UNetModel(**kw))
    back = reference_to_torch(ref, loaded)
    _assert_same_state(back, tmodel)
    loaded.load_state_dict(back, strict=True)
    _assert_same_state(reference_unet_to_torch(own, loaded), tmodel)
    _assert_same_tree({"unet": convert_unet(_numpy(ref), num_head_channels=8)}, params)

    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                        low_res=jnp.asarray(low), y=jnp.asarray(y))
    with torch.no_grad():
        got = loaded.eval()(torch.from_numpy(x), torch.from_numpy(t),
                            low_res=torch.from_numpy(low), y=torch.from_numpy(y).long())
    _close(got.numpy(), want, 1e-4)


# ------------------------------------------------------------------- ViT

VIT = dict(image_size=8, patch_size=2, in_channels=4, embed_dim=64, depth=3,
           num_heads=4, num_classes=10, drop_label_prob=0.1)
VIT_CASES = {
    "qkv_bias": dict(qkv_bias=True),
    "qkv_bias_rel_pos_bias": dict(qkv_bias=True, use_shared_rel_pos_bias=True),
    "rel_pos_bias": dict(use_shared_rel_pos_bias=True),
}


def _vit_reference_layout(sd, model):
    """The port's ViT state dict in the reference's form: each qkv bias as
    q_bias and v_bias (its k part must be zero), and the shared relative
    position bias's index buffer."""
    out = {}
    for name, v in sd.items():
        if name.endswith("attn.qkv.bias"):
            q, k, vb = v.chunk(3)
            assert not k.any()
            out[name.replace("qkv.bias", "q_bias")] = q.clone()
            out[name.replace("qkv.bias", "v_bias")] = vb.clone()
        else:
            out[name] = v.clone()
    if model.rel_pos_bias is not None:
        out["rel_pos_bias.relative_position_index"] = (
            model.rel_pos_bias.relative_position_index.clone())
    return out


@pytest.mark.parametrize("case", list(VIT_CASES))
def test_reference_vit_round_trips_and_matches_jax(case):
    kw = dict(VIT, **VIT_CASES[case])
    jmodel = JaxViT(**kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = rng.uniform(0, 999, 3).astype(np.float32)
    y = rng.integers(0, 10, 3).astype(np.int32)
    params = _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(y))["params"], seed=len(case))
    if kw.get("qkv_bias"):  # the reference holds no k bias
        for block in (v for k, v in params.items() if k.startswith("ViTBlock_")):
            block["ViTAttention_0"]["Dense_0"]["bias"][64:128] = 0.0
    tmodel = ViT(**kw)
    own = flax_to_torch(params)
    tmodel.load_state_dict(own, strict=True)
    ref = _vit_reference_layout(own, tmodel)
    assert any(k.endswith("q_bias") for k in ref) == bool(kw.get("qkv_bias"))

    loaded = ViT(**kw)
    back = reference_vit_to_torch(ref, loaded)
    _assert_same_state(back, tmodel)
    loaded.load_state_dict(back, strict=True)
    assert reference_to_torch(ref, loaded).keys() == back.keys()
    _assert_same_state(reference_vit_to_torch(own, loaded), tmodel)
    _assert_same_tree(convert_vit(_numpy(ref)), params)

    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = loaded.eval()(torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---------------------------------------------- the families with no reshape

SMALL = {
    "dit": (lambda: JaxDiT(image_size=8, patch_size=2, in_channels=4, hidden_size=64,
                           depth=2, num_heads=2, num_classes=10, class_dropout_prob=0.1),
            lambda: DiT(image_size=8, patch_size=2, in_channels=4, hidden_size=64,
                        depth=2, num_heads=2, num_classes=10, class_dropout_prob=0.1),
            convert_dit),
    "mmdit": (lambda: JaxMMDiT(image_size=8, patch_size=2, in_channels=4, hidden_size=64,
                               depth=2, num_heads=2, num_classes=0, context_tokens=2),
              lambda: MMDiT(image_size=8, patch_size=2, in_channels=4, hidden_size=64,
                            depth=2, num_heads=2, num_classes=0, context_tokens=2),
              convert_mmdit),
    "uvit": (lambda: JaxUViT(image_size=8, patch_size=2, in_channels=4, embed_dim=64,
                             depth=3, num_heads=4, num_classes=10, class_dropout_prob=0.1),
             lambda: UViT(image_size=8, patch_size=2, in_channels=4, embed_dim=64, depth=3,
                          num_heads=4, num_classes=10, class_dropout_prob=0.1),
             convert_uvit),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_reference_to_torch_reads_every_family(name):
    """The DiT's and MM-DiT's stored sin-cos table is dropped (the port
    recomputes it); U-ViT's names are the port's."""
    jctor, tctor, convert = SMALL[name]
    jmodel = jctor()
    x, t = jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,))
    y = jnp.zeros((2,), jnp.int32) if name != "mmdit" else None
    params = _randomize(jmodel.init(jax.random.key(0), x, t, y)["params"], seed=9)
    tmodel = tctor()
    own = flax_to_torch(params)
    tmodel.load_state_dict(own, strict=True)
    ref = dict(own)
    if name != "uvit":
        ref["pos_embed"] = tmodel.pos_embed[None].clone()
    loaded = tctor()
    back = reference_to_torch(ref, loaded)
    _assert_same_state(back, tmodel)
    loaded.load_state_dict(back, strict=True)
    _assert_same_tree(convert(_numpy(ref)), params)


def test_readers_refuse_names_the_model_lacks():
    unet = port_unet.UNetModel(**dict(UNET, num_head_channels=8))
    sd = _unet_reference_layout(unet.state_dict(), unet)
    with pytest.raises(ValueError, match="UNet"):
        reference_unet_to_torch(dict(sd, **{"input_blocks.9.0.weight": torch.zeros(1)}), unet)
    vit = ViT(**dict(VIT, qkv_bias=True))
    vsd = {k: v.clone() for k, v in vit.state_dict().items()}
    with pytest.raises(ValueError, match="ViT"):
        reference_vit_to_torch(dict(vsd, **{"blocks.0.attn.k_bias": torch.zeros(64)}), vit)
    with pytest.raises(ValueError, match="expected q and v"):
        reference_vit_to_torch(dict(vsd, **{"blocks.0.attn.q_bias": torch.zeros(64)}), vit)
    dit = SMALL["dit"][1]()
    with pytest.raises(ValueError, match="DiT"):
        reference_to_torch(dict(dit.state_dict(), bogus=torch.zeros(1)), dit)
    with pytest.raises(ValueError, match="no reference reader"):
        reference_to_torch({}, torch.nn.Linear(2, 2))
