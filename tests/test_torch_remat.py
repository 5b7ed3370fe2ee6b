"""Remat and scanned blocks in the port (vaw_torch/models: use_checkpoint
with the "full" and "dots" policies of layers.REMAT_POLICIES, the DiT's
forward_with_cfg, the scanned JAX DiT's tree converted) against the port
without remat and against the JAX package's models with the same flags.

- Bit-equal: the forward and every parameter gradient with use_checkpoint
  under either policy equal those without it, for the DiT, the U-ViT and
  the UNet; the UNet in training with dropout > 0 (the recompute draws the
  same mask: the default generator is replayed), under both
  VAW_PALLAS_CONV values.
- Against JAX: the same Flax params (seeded numpy noise, rematted or
  scanned trees converted by vaw_torch.models.convert) and inputs; the f32
  forward within 1e-4 (atol, as tests/test_torch_dit.py; relative to
  max|out| for the U-ViT and UNet, as their files), each gradient within
  1e-4 of the largest gradient of its layer group (f32 on both sides, JAX
  at "highest" matmul precision, different summation order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models import build_model
from vaw_torch.models import unet as port_unet
from vaw_torch.models.convert import flax_to_torch
from vaw_torch.models.dit import DiT
from vaw_torch.models.layers import REMAT_POLICIES, remat_with_policy
from vaw_torch.models.uvit import UViT
from vaw_torch.utils.config import TrainConfig
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.models.unet import UNetModel as JaxUNet
from vaw_tpu.models.uvit import UViT as JaxUViT

POLICIES = sorted(REMAT_POLICIES)
DIT = dict(image_size=16, patch_size=2, in_channels=4, hidden_size=64, depth=3,
           num_heads=2, num_classes=10, class_dropout_prob=0.1)
UVIT = dict(image_size=8, patch_size=2, in_channels=4, embed_dim=64, depth=5,
            num_heads=4, num_classes=10, class_dropout_prob=0.1)
UNET = dict(image_size=32, in_channels=4, model_channels=32, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_head_channels=8, num_classes=10, drop_label_prob=0.1)
SHAPES = {"dit": (16, 16, 4), "uvit": (8, 8, 4), "unet": (32, 32, 4)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, restored after it: the suite runs several
    test processes side by side, and torch's default of a thread per core
    in each oversubscribes the machine, which makes these many small ops
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf (the zero-initialised heads
    included): kernels ~ 1/sqrt(fan_in), norm scales ~ 1 + 0.1 N, tables and
    pos_embed ~ 0.3, biases ~ 0.05."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            fan_in = np.prod(p.shape[:-1])
            if any("ScanBlocks" == getattr(k, "key", None) for k in path):
                fan_in = np.prod(p.shape[1:-1])  # the leading depth axis
            return (z / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        std = 0.3 if name in ("embedding", "pos_embed") else 0.05
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _inputs(family, n=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *SHAPES[family])).astype(np.float32)
    t = rng.uniform(0, 999, n).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    w = rng.standard_normal((n, *SHAPES[family])).astype(np.float32)
    return x, t, y, w


def _jax_pair(family, seed=0, **flags):
    """(JAX model, its seeded params, the port's model on those params).
    scan_blocks goes to the JAX DiT only: the port's DiT has one form."""
    port_flags = {k: v for k, v in flags.items() if k != "scan_blocks"}
    if family == "dit":
        jmodel, tmodel = JaxDiT(**DIT, **flags), DiT(**DIT, **port_flags)
    elif family == "uvit":
        jmodel, tmodel = JaxUViT(**UVIT, **flags), UViT(**UVIT, **flags)
    else:
        jmodel, tmodel = JaxUNet(**UNET, **flags), port_unet.UNetModel(**UNET, **flags)
    x = jnp.zeros((1, *SHAPES[family]))
    params = jmodel.init(jax.random.key(0), x, jnp.zeros((1,)),
                         jnp.zeros((1,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, _randomize(params, seed))
    tmodel.load_state_dict(flax_to_torch(params, tmodel), strict=True)
    return jmodel, params, tmodel


def _jax_out_and_grads(jmodel, params, x, t, y, w):
    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * jnp.asarray(w)), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def _port_out_and_grads(tmodel, x, t, y, w, train=False):
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long(),
                 train=train)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in tmodel.named_parameters()}


def _group(name: str) -> str:
    """A layer's group: its name without block indices and without the
    weight/bias leaf (blocks.2.attn.qkv.bias -> blocks.attn.qkv)."""
    return ".".join(p for p in name.split(".")[:-1] if not p.isdigit()) or name


def _assert_grads_near(got, want_tree, tmodel):
    """Each gradient within 1e-4 of the largest gradient magnitude of its
    layer group (chip_smoke.py's phase-7 rule): a conv bias just before a
    GroupNorm has a gradient near zero that summation order alone moves by
    more than its size."""
    want = flax_to_torch(want_tree, tmodel)
    assert set(got) == set(want)
    scale = {}
    for k, w in want.items():
        scale[_group(k)] = max(scale.get(_group(k), 0.0), w.abs().max().item())
    for k, g in got.items():
        err = (g - want[k]).abs().max().item() / max(scale[_group(k)], 1e-6)
        assert err <= 1e-4, (k, err)


def _port_model(family, seed=0, dropout=0.0, **flags):
    torch.manual_seed(seed)
    if family == "dit":
        model = DiT(**DIT, **flags)
    elif family == "uvit":
        model = UViT(**UVIT, **flags)
    else:
        model = port_unet.UNetModel(**UNET, dropout=dropout, **flags)
    with torch.no_grad():  # no zero-initialised head: every block matters
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return model.train()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["dit", "uvit", "unet"])
def test_remat_is_bit_equal_to_no_remat(family, policy):
    model = _port_model(family)
    x, t, y, w = _inputs(family)
    want_out, want = _port_out_and_grads(model, x, t, y, w)
    rematted = _port_model(family, use_checkpoint=True, remat_policy=policy)
    rematted.load_state_dict(model.state_dict())
    got_out, got = _port_out_and_grads(rematted, x, t, y, w)
    assert torch.equal(got_out, want_out)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("pallas_conv", ["0", "1"])
@pytest.mark.parametrize("policy", POLICIES)
def test_unet_remat_with_dropout_is_bit_equal(policy, pallas_conv, monkeypatch):
    monkeypatch.setenv("VAW_PALLAS_CONV", pallas_conv)
    plain = _port_model("unet", dropout=0.3)
    rematted = _port_model("unet", dropout=0.3, use_checkpoint=True, remat_policy=policy)
    rematted.load_state_dict(plain.state_dict())
    assert (any(isinstance(m, port_unet.PallasConv3x3) for m in rematted.modules())
            == (pallas_conv == "1"))
    x, t, y, w = _inputs("unet")
    outs, grads = [], []
    for model in (plain, rematted):
        torch.manual_seed(7)  # the dropout masks
        out, g = _port_out_and_grads(model, x, t, y, w, train=True)
        outs.append(out)
        grads.append(g)
    torch.manual_seed(8)
    other, _ = _port_out_and_grads(plain, x, t, y, w, train=True)
    assert not torch.equal(other, outs[0])  # dropout is on
    assert torch.equal(outs[1], outs[0])
    for k in grads[0]:
        assert torch.equal(grads[1][k], grads[0][k]), k


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["dit", "uvit", "unet"])
def test_remat_matches_jax_with_the_same_flags(family, policy):
    jmodel, params, tmodel = _jax_pair(family, use_checkpoint=True, remat_policy=policy)
    top = {str(k).split("_")[0] for k in params}
    assert any(s.startswith("Checkpoint") for s in top), top  # a rematted tree
    x, t, y, w = _inputs(family)
    want_out, want_grads = _jax_out_and_grads(jmodel, params, x, t, y, w)
    got_out, got = _port_out_and_grads(tmodel, x, t, y, w)
    if family == "dit":
        np.testing.assert_allclose(got_out.numpy(), want_out, atol=1e-4, rtol=0)
    else:
        err = np.abs(got_out.numpy() - want_out).max() / np.abs(want_out).max()
        assert err <= 1e-4, err
    _assert_grads_near(got, want_grads, tmodel)


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_scanned_jax_dit_converts_to_the_port(use_checkpoint):
    """The scanned Flax DiT's ScanBlocks leaves (leading depth axis) land on
    blocks.{i}; the port's DiT on them gives JAX's output and gradients
    (model: tests/test_dit_scan.py:18)."""
    flags = dict(scan_blocks=True, use_checkpoint=use_checkpoint)
    jmodel, params, tmodel = _jax_pair("dit", **flags)
    assert "ScanBlocks" in params
    x, t, y, w = _inputs("dit")
    want_out, want_grads = _jax_out_and_grads(jmodel, params, x, t, y, w)
    got_out, got = _port_out_and_grads(tmodel, x, t, y, w)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=1e-4, rtol=0)
    _assert_grads_near(got, want_grads, tmodel)
    unrolled = DiT(**DIT)
    unrolled.load_state_dict(tmodel.state_dict())  # the same state-dict names
    with torch.no_grad():
        assert torch.equal(unrolled(*(torch.from_numpy(a) for a in (x, t)),
                                    torch.from_numpy(y).long()), got_out)


def test_converted_scan_tree_unstacks_every_block():
    from vaw_torch.models.convert import flax_train_state_to_torch

    _, scanned, _ = _jax_pair("dit", scan_blocks=True)
    _, unrolled, _ = _jax_pair("dit")
    sd = flax_to_torch(scanned)
    assert sorted({k.split(".")[1] for k in sd if k.startswith("blocks.")}) == ["0", "1", "2"]
    stacked = scanned["ScanBlocks"]["DiTBlock_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(sd["blocks.2.adaLN_modulation.1.weight"].numpy(),
                                  stacked[2].T)
    assert set(sd) == set(flax_to_torch(unrolled))

    class Adam(tuple):
        _fields = ("count", "mu", "nu")

        def __new__(cls, count, mu, nu):
            obj = super().__new__(cls, (count, mu, nu))
            obj.count, obj.mu, obj.nu = count, mu, nu
            return obj

    state = flax_train_state_to_torch(scanned, scanned, (Adam(np.int32(3), scanned, scanned),))
    assert state["opt"]["count"] == 3 and set(state["opt"]["mu"]) == set(sd)


@pytest.mark.parametrize("cfg_scale", [1.0, 4.0])
def test_forward_with_cfg_matches_jax(cfg_scale):
    jmodel, params, tmodel = _jax_pair("dit")
    x, t, _, _ = _inputs("dit", n=4)
    y = np.array([3, 7, 10, 10], np.int32)  # conditional half, then the null label
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                        cfg_scale, method=jmodel.forward_with_cfg)
    with torch.no_grad():
        got = tmodel.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(y).long(), cfg_scale)
    assert got.shape == (4, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # The reference's quirk: only three channels are guided (the same rows
    # in both halves); the rest pass through from each half's own labels.
    torch.testing.assert_close(got[:2, ..., :3], got[2:, ..., :3], rtol=0, atol=0)
    if cfg_scale != 1.0:
        with torch.no_grad():
            plain = tmodel(torch.from_numpy(x[:2]), torch.from_numpy(t[:2]),
                           torch.from_numpy(y[:2]).long())
        assert not torch.allclose(got[:2, ..., :3], plain[..., :3])


def test_remat_with_policy_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="Unknown remat_policy"):
        remat_with_policy(torch.nn.Identity(), "everything")
    with pytest.raises(ValueError, match="Unknown remat_policy"):
        DiT(**DIT, use_checkpoint=True, remat_policy="offload")


def test_dots_saves_only_the_unbatched_products():
    """Under "dots" the backward recomputes everything but the Linear
    products: the recompute runs no aten.mm / aten.addmm, while "full" runs
    them again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    block = _port_model("dit").blocks[0]
    x = torch.randn(2, 5, 64, requires_grad=True)
    c = torch.randn(2, 64, requires_grad=True)
    products = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    counts = {}
    for policy in POLICIES:
        out = remat_with_policy(block, policy)(x, c)
        with Count() as mode:
            out.sum().backward()
        counts[policy] = sum(op in products for op in mode.ops)
    assert counts["dots"] < counts["full"]
    out = block(x, c)
    with Count() as mode:  # the same backward without remat
        out.sum().backward()
    assert counts["dots"] == sum(op in products for op in mode.ops)
    assert counts["full"] == counts["dots"] + 5  # the block's five Linears again


def test_build_model_passes_remat_and_scan_through():
    cfg = TrainConfig(model="DiT-S", image_size=8, patch_size=2, in_chans=4,
                      num_classes=10, class_cond=True, use_checkpoint=True,
                      remat_policy="dots", scan_blocks=True)
    model = build_model(cfg, device="meta")
    assert (model.use_checkpoint, model.remat_policy) == (True, "dots")
    cfg.scan_blocks = False
    plain = build_model(cfg, device="meta")  # the flag changes no state name or shape
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    cfg.scan_blocks = True
    cfg.learn_align = True
    with pytest.raises(ValueError, match="scan_blocks is incompatible"):
        build_model(cfg, device="meta")
    cfg = TrainConfig(model="U-ViT-S", image_size=8, patch_size=2, in_chans=4,
                      num_classes=10, use_checkpoint=True)
    assert build_model(cfg, device="meta").use_checkpoint
    cfg = TrainConfig(model="LDM", image_size=32, in_chans=4, num_classes=10,
                      use_checkpoint=True, remat_policy="dots")
    with torch.device("meta"):
        unet = build_model(cfg, device="meta")
    assert unet.input_blocks[1].remat == "dots" and unet.middle_block.remat == "dots"
