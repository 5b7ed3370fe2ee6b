"""The attention switches of the port (vaw_torch/ops/attention.py) against
the JAX package's (vaw_tpu/ops/attention.py, vaw_tpu/models/*.py):
VAW_FUSED_TMAJOR, VAW_PACKED_QKV and VAW_DISABLE_FLASH.

Routes. Each family's small model runs one forward in both packages under
each setting, with spies on the entries each package reaches last: the
port's ``flash_attention_fused``, ``flash_attention_packed``'s p5 and
general kernels, ``flash_attention`` and ``xla_attention``; the JAX
package's ``flash_attention_fused``, ``flash_attention_packed`` (p5 where
its own ``_packed5_supported`` says so), ``flash_attention`` and
``_xla_attention``, patched where its modules import them at call time. The
JAX side is told it runs on a TPU (its routing reads ``jax.devices()`` and
``jax.default_backend()``), and its kernel spies compute ``_xla_attention``,
so no Pallas kernel runs. Every attention runs at T >= 256 (the JAX
package's T gate) with H*D % 128 == 0 where the DiT's fused kernel is
concerned (the JAX p6 gate's lane rule): there the port must take JAX's
route call for call. Elsewhere the port's wider gates differ by design
(vaw_torch/ops/attention.py): below T = 256 it takes its kernels where JAX
takes XLA, and the DiT at T != 256 (the REPA teacher's 257) keeps its fused
kernel where JAX goes on to the packed entry.

Values. The f32 forwards agree within each family's tolerance of
tests/test_torch_{dit,uvit,vit,mmdit,unet,classifier}.py (atol 1e-4, or
1e-4 of max|out|) under every setting. Under VAW_DISABLE_FLASH=1 both run the same
XLA math: in the port's bf16 forward each attention call's output is within
one bf16 ulp of its max|o| (2**(floor(log2 max|o|) - 7)) of JAX's on the
same inputs, and the whole forward within the families' bf16 tolerance of
JAX's bf16 forward (3e-2 of max|out|; bf16 products and norms in two
libraries differ by more than one ulp of the output). The port's
``xla_attention`` alone holds to ``_xla_attention`` within 1e-6 in f32 and
one bf16 ulp of max|o| in bf16, gradients within 1e-5 in f32.
"""

from __future__ import annotations

import copy
import functools
import math
import types
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.models import cast_for_compute
from vaw_torch.models import unet as port_unet
from vaw_torch.models.convert import flax_to_torch
from vaw_torch.models.dit import DiT
from vaw_torch.models.mmdit import MMDiT
from vaw_torch.models.uvit import UViT
from vaw_torch.models.vit import ViT
from vaw_torch.ops import attention as port_attention
from vaw_torch.ops import flash_attention as port_flash
from vaw_tpu.models import unet as jax_unet
from vaw_tpu.models.dit import DiT as JaxDiT
from vaw_tpu.models.mmdit import MMDiT as JaxMMDiT
from vaw_tpu.models.uvit import UViT as JaxUViT
from vaw_tpu.models.vit import ViT as JaxViT
from vaw_tpu.ops import attention as jax_attention
from vaw_tpu.ops import flash_attention as jax_flash

SETTINGS = {
    "default": {},
    "fused_tmajor_0": {"VAW_FUSED_TMAJOR": "0"},
    "fused_tmajor_0_packed_qkv_0": {"VAW_FUSED_TMAJOR": "0", "VAW_PACKED_QKV": "0"},
    "packed_qkv_0": {"VAW_PACKED_QKV": "0"},
    "disable_flash": {"VAW_DISABLE_FLASH": "1"},
}
SWITCHES = ("VAW_FUSED_TMAJOR", "VAW_PACKED_QKV", "VAW_DISABLE_FLASH")


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
    norm scales ~ 1 + 0.1 N, layer scales ~ 0.5 + 0.1 N, tables ~ 0.3,
    biases ~ 0.05 (zero-initialised heads included, so no block is the
    identity)."""
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
        std = 0.3 if name in ("embedding", "pos_embed", "register",
                              "relative_position_bias_table") else 0.05
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


class Family(NamedTuple):
    """A small model of one family: the JAX module (by compute dtype), the
    port's, the input image, whether it takes a label, and the route each
    attention call takes under each setting, in call order."""
    jax_ctor: Callable
    port_ctor: Callable
    image: tuple
    labels: bool
    routes: Callable  # setting name -> list of routes
    atol: float = 0.0  # absolute tolerance in f32, else relative
    rtol: float = 0.0


def _same(n, fused="fused", packed="packed/general"):
    """Routes of n self-attention calls through a fused projection."""
    def routes(setting):
        split = SETTINGS[setting].get("VAW_PACKED_QKV") == "0"
        if setting == "disable_flash":
            return ["xla"] * n
        if SETTINGS[setting].get("VAW_FUSED_TMAJOR") != "0" and fused:
            return [fused] * n
        return ["general" if split else packed] * n
    return routes


DIT = dict(image_size=32, patch_size=2, in_channels=4, hidden_size=128, depth=2,
           num_heads=2, num_classes=10, class_dropout_prob=0.1)
UVIT = dict(image_size=32, patch_size=2, in_channels=4, embed_dim=64, depth=3,
            num_heads=4, num_classes=10, class_dropout_prob=0.1)
VIT = dict(image_size=32, patch_size=2, in_channels=4, embed_dim=64, depth=2,
           num_heads=4, num_classes=10, drop_label_prob=0.1)
MMDIT = dict(image_size=32, patch_size=2, in_channels=4, hidden_size=64, depth=2,
             num_heads=2, num_classes=10, class_dropout_prob=0.1)
# Attention at 16x16 (T = 256, eight heads of 8): the input, middle and
# two output blocks of that level, each on the p5 kernels by default.
UNET = dict(image_size=32, in_channels=4, model_channels=32, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_head_channels=8, num_classes=10, drop_label_prob=0.1)
# The classifier: two AttentionBlocks at 16x16 and the attention pool over
# the 16x16 map and its mean token (T = 257).
ENCODER = dict(image_size=32, in_channels=4, model_channels=16, out_channels=5,
               num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
               num_head_channels=8, pool="attention")


def _encoder_routes(setting):
    return _same(2, fused=None, packed="packed/p5")(setting) + (
        ["xla"] if setting == "disable_flash" else ["general"])


FAMILIES = {
    "dit": Family(lambda dt: JaxDiT(**DIT, dtype=dt), lambda: DiT(**DIT), (32, 32, 4),
                  True, _same(2, packed="packed/p5"), atol=1e-4),
    "uvit": Family(lambda dt: JaxUViT(**UVIT, dtype=dt), lambda: UViT(**UVIT), (32, 32, 4),
                   True, _same(3, fused=None), rtol=1e-4),
    "vit": Family(lambda dt: JaxViT(**VIT, dtype=dt), lambda: ViT(**VIT), (32, 32, 4),
                  True, _same(2, fused=None), atol=1e-4),
    "mmdit": Family(lambda dt: JaxMMDiT(**MMDIT, dtype=dt), lambda: MMDiT(**MMDIT),
                    (32, 32, 4), True,
                    lambda s: ["xla" if s == "disable_flash" else "general"] * 2, atol=1e-4),
    "unet": Family(lambda dt: jax_unet.UNetModel(**UNET, dtype=dt),
                   lambda: port_unet.UNetModel(**UNET), (32, 32, 4), True,
                   _same(4, fused=None, packed="packed/p5"), rtol=1e-4),
    "encoder_unet": Family(lambda dt: jax_unet.EncoderUNetModel(**ENCODER, dtype=dt),
                           lambda: port_unet.EncoderUNetModel(**ENCODER), (32, 32, 4),
                           False, _encoder_routes, rtol=1e-4),
}


def _inputs(fam: Family, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *fam.image)).astype(np.float32)
    t = rng.uniform(0, 999, 2).astype(np.float32)
    y = rng.integers(0, 10, 2).astype(np.int32) if fam.labels else None
    return x, t, y


@functools.cache
def _pair(name):
    """The family's Flax params (seeded) and the port's f32 model on them."""
    fam = FAMILIES[name]
    x, t, y = _inputs(fam)
    args = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(y),) if fam.labels else ())
    params = _randomize(fam.jax_ctor(jnp.float32).init(jax.random.key(0), *args)["params"],
                        seed=len(name))
    tmodel = fam.port_ctor()
    tmodel.load_state_dict(flax_to_torch(params, model=tmodel), strict=True)
    return params, tmodel.eval()


def _first(out):
    """The prediction: the DiT and MM-DiT return (out, zs)."""
    return out[0] if isinstance(out, tuple) else out


def _run_both(name, dtype=torch.float32):
    fam = FAMILIES[name]
    params, tmodel = _pair(name)
    x, t, y = _inputs(fam, seed=2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(y),) if fam.labels else ())
    want = np.asarray(_first(fam.jax_ctor(jdt).apply({"params": params}, *args)),
                      np.float32)
    if dtype != torch.float32:
        tmodel = cast_for_compute(copy.deepcopy(tmodel), dtype)
    targs = (torch.from_numpy(x), torch.from_numpy(t)) + (
        (torch.from_numpy(y).long(),) if fam.labels else ())
    with torch.no_grad():
        got = _first(tmodel(*targs)).float().numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    return got, want


class _OnTPU:
    """``jax`` as vaw_tpu/ops/attention.py sees it, but on a TPU: its
    routing takes the Pallas entries (which the spies replace)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices():
        return [types.SimpleNamespace(platform="tpu")]

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def routes(monkeypatch):
    """Spies on both packages' last attention entries; returns the two
    lists of routes taken, (port, jax)."""
    port, jx = [], []
    xla = jax_attention._xla_attention

    def jax_fused(qkv2d, num_heads, scale=None):
        jx.append("fused")
        b, t, hd3 = qkv2d.shape
        d = hd3 // (3 * num_heads)
        q, k, v = (a.reshape(b, t, num_heads, d) for a in jnp.split(qkv2d, 3, axis=-1))
        return xla(q, k, v, scale or 1.0 / math.sqrt(d)).reshape(b, t, -1)

    def jax_packed(qkv, scale=None, d_major_out=False):
        b, t, _, h, d = qkv.shape
        jx.append("packed/p5" if jax_flash._packed5_supported(b, h, d, t)
                  else "packed/general")
        out = xla(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], scale or 1.0 / math.sqrt(d))
        return out.transpose(0, 2, 3, 1).reshape(b, h * d, t) if d_major_out else out

    def jax_general(q, k, v, scale=None):
        jx.append("general")
        return xla(q, k, v, scale or 1.0 / math.sqrt(q.shape[-1]))

    def jax_xla(q, k, v, scale):
        jx.append("xla")
        return xla(q, k, v, scale)

    monkeypatch.setattr(jax_attention, "jax", _OnTPU())
    monkeypatch.setattr(jax_attention, "_xla_attention", jax_xla)
    monkeypatch.setattr(jax_flash, "flash_attention_fused", jax_fused)
    monkeypatch.setattr(jax_flash, "flash_attention_packed", jax_packed)
    monkeypatch.setattr(jax_flash, "flash_attention", jax_general)

    def spy(module, name, route):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, **kw: port.append(route) or real(*a, **kw))

    spy(port_attention, "flash_attention_fused", "fused")
    spy(port_attention, "flash_attention", "general")
    spy(port_attention, "xla_attention", "xla")
    spy(port_flash, "flash_attention_p5", "packed/p5")
    real_packed = port_flash._FlashPacked.apply
    monkeypatch.setattr(port_flash._FlashPacked, "apply",
                        lambda *a: port.append("packed/general") or real_packed(*a))
    return port, jx


def _setting(monkeypatch, setting):
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    for key, value in SETTINGS[setting].items():
        monkeypatch.setenv(key, value)


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_port_takes_the_jax_route(name, setting, routes, monkeypatch):
    """Call for call the JAX package's route at T >= 256, and the f32
    forward within the family's tolerance."""
    _setting(monkeypatch, setting)
    fam = FAMILIES[name]
    port, jx = routes
    _pair(name)  # Flax's init runs a forward: count only the one below
    port.clear()
    jx.clear()
    got, want = _run_both(name)
    assert jx == fam.routes(setting), jx
    assert port == jx, (port, jx)
    if fam.atol:
        np.testing.assert_allclose(got, want, atol=fam.atol, rtol=0)
    else:
        assert np.abs(got - want).max() <= fam.rtol * np.abs(want).max()


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_disabled_flash_bf16_attention_within_one_ulp_of_jax(name, monkeypatch):
    """Under VAW_DISABLE_FLASH the port's bf16 forward takes xla_attention
    only; each call's output is within one bf16 ulp of its max|o| of JAX's
    _xla_attention on the same bf16 q, k and v, and the whole forward is
    within the families' bf16 tolerance (3e-2 of max|out|) of JAX's bf16
    forward, which differs in more than attention (bf16 products and norms
    in two libraries)."""
    _setting(monkeypatch, "disable_flash")
    calls = []
    real = port_attention.xla_attention

    def recorded(q, k, v, scale=None):
        out = real(q, k, v, scale)
        calls.append((q, k, v, scale, out))
        return out

    monkeypatch.setattr(port_attention, "xla_attention", recorded)
    got, want = _run_both(name, torch.bfloat16)
    assert calls and all(q.dtype == torch.bfloat16 for q, *_ in calls)
    for q, k, v, scale, out in calls:
        jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (q, k, v))
        ref = np.asarray(jax_attention._xla_attention(
            jq, jk, jv, scale or 1.0 / math.sqrt(q.shape[-1])).astype(jnp.float32))
        err, bound = np.abs(out.float().numpy() - ref).max(), _bf16_ulp(np.abs(ref).max())
        assert err <= bound, (err, bound)
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("d", [192, 12])
def test_dit_head_dims_the_fused_kernel_refuses_route_on(d, routes, monkeypatch):
    """A head dim the fused kernel does not take (D > 128, D % 8 != 0)
    goes on to the packed entry, as in the JAX package: the general kernel
    at D = 192, the plain math at D = 12; never the fused kernel."""
    _setting(monkeypatch, "default")
    kw = dict(DIT, hidden_size=2 * d)
    params = _randomize(JaxDiT(**kw).init(jax.random.key(0), jnp.zeros((2, 32, 32, 4)),
                                          jnp.zeros((2,)), jnp.zeros((2,), jnp.int32))
                        ["params"], seed=d)
    tmodel = DiT(**kw)
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    x, t, y = _inputs(FAMILIES["dit"], seed=3)
    port, jx = routes
    port.clear()  # Flax's init ran a forward
    jx.clear()
    want, _ = JaxDiT(**kw).apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(y))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(y).long())
    assert jx == ["packed/general" if d == 192 else "xla"] * 2
    assert port == jx
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_switch_values_read_as_in_jax(monkeypatch):
    """Each switch at unset, "1", "0", "" and "true", read at the call:
    VAW_FUSED_TMAJOR and VAW_PACKED_QKV are on only unset or at "1";
    VAW_DISABLE_FLASH is on at any non-empty value, "0" included."""
    pairs = ((port_attention.fused_tmajor_enabled, jax_attention.fused_tmajor_enabled,
              "VAW_FUSED_TMAJOR"),
             (port_attention.packed_qkv_enabled, jax_attention.packed_qkv_enabled,
              "VAW_PACKED_QKV"))
    for value in (None, "1", "0", "", "true"):
        for key in SWITCHES:
            if value is None:
                monkeypatch.delenv(key, raising=False)
            else:
                monkeypatch.setenv(key, value)
        for port_fn, jax_fn, key in pairs:
            assert port_fn() == jax_fn() == (value in (None, "1")), (key, value)
        assert port_attention.flash_disabled() == bool(value)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 256, 256, 4, 64), (2, 64, 64, 4, 12),
                                   (2, 20, 33, 3, 12)])
def test_xla_attention_matches_jax(shape, dtype):
    b, tq, tk, h, d = shape
    rng = np.random.default_rng(tq + d)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, tk, h, d)).astype(np.float32) for _ in range(2))
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tq_, tk_, tv_ = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    # the bf16 values themselves go to JAX, so both round the same inputs
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jdt) for a in (tq_, tk_, tv_))
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(jax_attention._xla_attention(jq, jk, jv, scale).astype(jnp.float32))
    got = port_attention.xla_attention(tq_, tk_, tv_)
    assert got.dtype == tdt and got.shape == (b, tq, h, d)
    bound = 1e-6 if dtype == "f32" else _bf16_ulp(np.abs(want).max())
    assert np.abs(got.float().numpy() - want).max() <= bound
    if dtype == "f32":
        g = rng.standard_normal((b, tq, h, d)).astype(np.float32)
        want_g = jax.grad(lambda q, k, v: jnp.sum(
            jax_attention._xla_attention(q, k, v, scale) * g), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (port_attention.xla_attention(*xs) * torch.from_numpy(g)).sum().backward()
        for x, w in zip(xs, want_g):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-5, rtol=0)
