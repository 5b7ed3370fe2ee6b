"""The XL models' head dim of 72 (DiT-XL/2, U-ViT-H/2, ViT-XL) on the TMA +
wgmma attention kernels: the general forward (csrc/flash_fwd.cu) and the
general backward pair (csrc/flash_bwd.cu), which also take the fused
entries' bf16 calls at that head dim, padded to 80 columns.

The kernels cannot run here, so a plain-torch emulation of their 80-wide
tiling stands in for them on the CPU: the head dim padded to 80 with zero
columns (TMA's fill past D), products in 16-deep steps, 128-row work items
(queries in the forward and the dQ kernel, keys in the dK/dV kernel)
against 64-row tiles, the forward's online softmax in the log2 domain, and
P and dS entering their products as bf16 hi + lo halves. It is held against
the plain versions and against the JAX package's Pallas kernels in
interpret mode (_flash_p6 at (1, 256, 16, 72), _flash at (1, 258, 16, 72)),
on inputs rounded to bf16, within the bf16 tolerance tests/test_ops.py:340
holds the Pallas kernels to: atol and rtol 2e-2. The routing rules, a small
DiT at D = 72 against the JAX package's, and the card's cases (marked
``cuda``; skipped without a card) follow.

JAX is imported inside the tests that compare with it, so the CUDA cases
also collect on a machine without JAX.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fused,
    flash_attention_fused_bwd,
    flash_attention_fused_bwd_reference,
    flash_attention_fused_reference,
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_reference,
    flash_bwd_design,
    flash_fused_bwd_design,
    flash_fused_fwd_design,
    flash_fwd_design,
)

BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_ops.py:340
DP, ITEM, TILE, STEP = 80, 128, 64, 16
LOG2E = 1.0 / math.log(2.0)


def _bf16(shape, rng, scale=1.0):
    """Seeded normal values rounded to bf16, held in f32."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).float()


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = _bf16((b, t, 3, h, d), rng, 0.5)
    return qkv, _bf16((b, t, h, d), rng)


def _split(p):
    """P -> its bf16 hi half (P cut to bf16) and lo half (bf16(P - hi))."""
    hi = (p.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).float()


def _heads(x, pad=DP):
    """[B, T, H, D] -> [B, H, T, pad], columns past D zero (TMA's fill)."""
    return F.pad(x.transpose(1, 2), (0, pad - x.shape[-1]))


def _depth_steps(a, b):
    """a b^T over the head dim in 16-deep steps, summed in f32."""
    return sum(a[..., c:c + STEP] @ b[..., c:c + STEP].transpose(-1, -2)
               for c in range(0, a.shape[-1], STEP))


def _width_steps(halves, x):
    """sum over halves of h x, 16 rows of x (keys or queries) a step."""
    return sum(h[..., r:r + STEP] @ x[..., r:r + STEP, :]
               for h in halves for r in range(0, h.shape[-1], STEP))


def emulate_fwd(q, k, v, scale, pad=None):
    """The forward kernel's arithmetic: 128-query items against 64-key
    tiles, S in 16-deep steps over the 80-wide head dim, the online softmax
    in the log2 domain, O += P v with P as bf16 hi + lo. Returns o [B, Tq, H,
    80] f32 (the 80 computed columns) and lse [B*H, Tq]. `pad`, if given,
    replaces the zero columns 72-79 of q, k and v (what a read past D of a
    packed row would find)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qh, kh, vh = (_heads(x) for x in (q, k, v))
    if pad is not None:
        for x, p in zip((qh, kh, vh), pad):
            x[..., d:] = _heads(p)[..., :DP - d]
    sl = scale * LOG2E
    o = torch.zeros(b, h, tq, DP)
    lse = torch.zeros(b, h, tq)
    for q0 in range(0, tq, ITEM):
        qi = qh[:, :, q0:q0 + ITEM]
        rows = qi.shape[2]
        m = torch.full((b, h, rows, 1), -math.inf)
        l = torch.zeros(b, h, rows, 1)
        acc = torch.zeros(b, h, rows, DP)
        for k0 in range(0, tk, TILE):
            s = _depth_steps(qi, kh[:, :, k0:k0 + TILE])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * sl - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _width_steps(_split(p), vh[:, :, k0:k0 + TILE])
            m = m_new
        o[:, :, q0:q0 + rows] = acc / l
        lse[:, :, q0:q0 + rows] = ((m + torch.log2(l)) / LOG2E)[..., 0]
    return o.transpose(1, 2), lse.reshape(b * h, tq)


def emulate_bwd(q, k, v, out, lse, dout, scale):
    """The backward pair's arithmetic over the 80-wide head dim. The dQ
    kernel: 128-query items, delta = rowsum(dout * out) in f32, per 64-key
    tile S and dP in 16-deep steps, P = exp2(S scale log2(e) - lse2), dS = P
    (dP - delta), dQ += dS k with dS as bf16 hi + lo, dQ scaled at the end.
    The dK/dV kernel: 128-key items, per 64-query tile S^T and dP^T, dV +=
    P^T dout and dK += dS^T q with P^T and dS^T as bf16 hi + lo, dK scaled
    at the end. Returns dq, dk, dv [B, T, H, 80] f32."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qh, kh, vh, oh, doh = (_heads(x) for x in (q, k, v, out, dout))
    sl = scale * LOG2E
    lse2 = (lse.reshape(b, h, tq) * LOG2E)[..., None]
    delta = (doh * oh).sum(-1, keepdim=True)
    dq = torch.zeros(b, h, tq, DP)
    for q0 in range(0, tq, ITEM):
        rows = slice(q0, q0 + ITEM)
        acc = 0.0
        for k0 in range(0, tk, TILE):
            keys = slice(k0, k0 + TILE)
            s = _depth_steps(qh[:, :, rows], kh[:, :, keys])
            dp = _depth_steps(doh[:, :, rows], vh[:, :, keys])
            ds = torch.exp2(s * sl - lse2[:, :, rows]) * (dp - delta[:, :, rows])
            acc = acc + _width_steps(_split(ds), kh[:, :, keys])
        dq[:, :, rows] = acc * scale
    dk, dv = torch.zeros(b, h, tk, DP), torch.zeros(b, h, tk, DP)
    for k0 in range(0, tk, ITEM):
        keys = slice(k0, k0 + ITEM)
        acc_k, acc_v = 0.0, 0.0
        for j0 in range(0, tq, TILE):
            rows = slice(j0, j0 + TILE)
            st = _depth_steps(kh[:, :, keys], qh[:, :, rows])
            dpt = _depth_steps(vh[:, :, keys], doh[:, :, rows])
            pt = torch.exp2(st * sl - lse2[:, :, rows].transpose(-1, -2))
            dst = pt * (dpt - delta[:, :, rows].transpose(-1, -2))
            acc_v = acc_v + _width_steps(_split(pt), doh[:, :, rows])
            acc_k = acc_k + _width_steps(_split(dst), qh[:, :, rows])
        dk[:, :, keys], dv[:, :, keys] = acc_k * scale, acc_v
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, dtype=np.float32),
                               err_msg=what, **BF16_TOL)


@pytest.mark.parametrize("b,t,h", [(1, 256, 16), (1, 258, 16), (2, 77, 3)])
def test_emulated_tiling_matches_the_plain_versions(b, t, h):
    """The 80-wide tiling against the plain forward and backward on the same
    bf16-valued inputs; the pad columns of every output are zero."""
    qkv, g = _qkv(b, t, h, 72, seed=t)
    q, k, v = qkv.unbind(2)
    scale = 72 ** -0.5
    o, lse = emulate_fwd(q, k, v, scale)
    want_o, want_lse = flash_attention_reference(q, k, v)
    assert torch.equal(o[..., 72:], torch.zeros_like(o[..., 72:]))
    _close(o[..., :72], want_o, "o")
    _close(lse, want_lse, "lse")
    out = o[..., :72].to(torch.bfloat16).float()
    grads = emulate_bwd(q, k, v, out, lse, g, scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads,
                               flash_attention_bwd_reference(q, k, v, out, lse, g)):
        assert torch.equal(got[..., 72:], torch.zeros_like(got[..., 72:])), name
        _close(got[..., :72], want, name)


def test_pad_columns_must_be_zero_and_not_the_next_heads():
    """Read past D of a packed row, columns 72-79 of head h are head h + 1's
    first eight: the tiling would then compute another function. TMA's fill
    past D gives zeros, so the kernels read only their own head."""
    qkv, _ = _qkv(1, 256, 4, 72, seed=11)
    q, k, v = qkv.unbind(2)
    want, _ = flash_attention_reference(q, k, v)
    own, _ = emulate_fwd(q, k, v, 72 ** -0.5)
    nxt = tuple(torch.roll(x, -1, dims=2) for x in (q, k, v))
    leaked, _ = emulate_fwd(q, k, v, 72 ** -0.5, pad=nxt)
    err_own = (own[..., :72] - want).abs().max().item()
    err_leaked = (leaked[..., :72] - want).abs().max().item()
    assert err_leaked > 10 * err_own, (err_leaked, err_own)
    assert leaked[..., 72:].abs().max() > 0


def test_emulated_tiling_matches_pallas_p6_interpret():
    """DiT-XL/2's attention at (1, 256, 16, 72): the emulated tiling against
    the JAX package's _flash_p6 forward (o and lse) and its Pallas backward
    (jax.grad through the custom_vjp), in interpret mode."""
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    b, t, h, d = 1, 256, 16, 72
    assert jax_flash.flash_fused_supported(b, h, d, t)
    qkv, g = _qkv(b, t, h, d, seed=21)
    f = qkv.reshape(b, t, 3 * h * d).numpy()
    scale = d ** -0.5
    want_o = jax_flash.flash_attention_fused(jnp.asarray(f), h)
    _, (_, _, want_lse) = jax_flash._flash_p6_fwd(jnp.asarray(f), h, scale)
    gf = g.reshape(b, t, h * d).numpy()
    want_g = jax.grad(lambda x: jnp.sum(jax_flash.flash_attention_fused(x, h) * gf))(
        jnp.asarray(f))
    q, k, v = qkv.unbind(2)
    o, lse = emulate_fwd(q, k, v, scale)
    _close(o[..., :72].reshape(b, t, h * d), want_o, "o")
    _close(lse, want_lse, "lse")
    out = o[..., :72].to(torch.bfloat16).float()
    grads = emulate_bwd(q, k, v, out, lse, g, scale)
    got = torch.stack([x[..., :72] for x in grads], dim=2).reshape(b, t, 3 * h * d)
    _close(got, want_g, "dqkv")


def test_emulated_tiling_matches_pallas_flash_interpret():
    """U-ViT-H/2's attention at (1, 258, 16, 72): the emulated tiling against
    the JAX package's _flash forward and backward, in interpret mode."""
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    qkv, g = _qkv(1, 258, 16, 72, seed=31)
    q, k, v = qkv.unbind(2)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    want_o = jax_flash.flash_attention(jq, jk, jv)
    want = jax.grad(lambda a, b_, c: jnp.sum(jax_flash.flash_attention(a, b_, c) * g.numpy()),
                    argnums=(0, 1, 2))(jq, jk, jv)
    scale = 72 ** -0.5
    o, lse = emulate_fwd(q, k, v, scale)
    _close(o[..., :72], want_o, "o")
    out = o[..., :72].to(torch.bfloat16).float()
    for name, got, w in zip(("dq", "dk", "dv"), emulate_bwd(q, k, v, out, lse, g, scale),
                            want):
        _close(got[..., :72], w, name)


@pytest.mark.parametrize("d", [72, 80])
def test_bf16_head_dims_72_and_80_take_wgmma(d):
    """bf16 with scale > 0 at D = 72 and 80: every entry's wgmma design (the
    fused forward's is the general kernel on the packed row's views, padded
    to 80, not 128)."""
    views = tuple(torch.zeros(2, 256, 3, 16, d, dtype=torch.bfloat16).unbind(2))
    scale = d ** -0.5
    assert flash_fwd_design(torch.bfloat16, d, scale, views) == "wgmma"
    assert flash_bwd_design(torch.bfloat16, d, scale, views * 2) == "wgmma"
    assert flash_fused_fwd_design(torch.bfloat16, d, scale, views) == "wgmma"
    assert flash_fused_bwd_design(torch.bfloat16, d, scale, views * 2) == "wgmma"
    assert flash_bwd_design(torch.bfloat16, d, scale) == "wgmma"


@pytest.mark.parametrize("dtype,d,scale,design", [
    (torch.bfloat16, 128, 0.3, "wgmma"),        # ViT-S's D = 128
    (torch.bfloat16, 72, -0.3, "mma_sync"),
    (torch.bfloat16, 72, 0.0, "mma_sync"),
    (torch.bfloat16, 88, 0.3, "wgmma"),
    (torch.float32, 72, 72 ** -0.5, "fma"),     # f32 stays: tf32x3 takes D <= 64
    (torch.float32, 80, 0.3, "fma"),
    (torch.float32, 64, 0.125, "tf32x3")])
def test_other_backward_calls_keep_their_kernels(dtype, d, scale, design):
    assert flash_bwd_design(dtype, d, scale) == design
    assert flash_fused_bwd_design(dtype, d, scale) == design


def test_fused_forward_design_for_every_admitted_head_dim():
    """bf16 fused forwards are "wgmma" at every admitted D with scale > 0
    (the fused kernel up to 64, the general one on the views above) and
    "mma_sync" with scale <= 0; f32 at D = 72 keeps its crossover rule,
    which a small call (32 score tiles) meets as a large one does."""
    for d in (40, 64, 72, 80, 88, 128):
        assert flash_fused_fwd_design(torch.bfloat16, d, d ** -0.5) == "wgmma"
        assert flash_fused_fwd_design(torch.bfloat16, d, -1.0) == "mma_sync"
    small = tuple(torch.zeros(1, 256, 3, 2, 72).unbind(2))
    large = tuple(torch.zeros(128, 256, 3, 16, 72).unbind(2))
    assert port_flash.score_tiles(1, 256, 256, 2) >= port_flash.TF32X3_MIN_TILES
    assert flash_fused_fwd_design(torch.float32, 72, 72 ** -0.5, small) == "tf32x3"
    assert flash_fused_fwd_design(torch.float32, 72, 72 ** -0.5, large) == "tf32x3"
    assert flash_fused_fwd_design(torch.float32, 72, -1.0, small) == "fma"


def _dit_pair(seed=4):
    """A JAX DiT at D = 72 (hidden 144, 2 heads, depth 2) with seeded weights,
    and the port's DiT on the same weights through models/convert.py."""
    import jax
    import jax.numpy as jnp
    from _torch_jax_dit import randomize

    from vaw_torch.models.convert import flax_dit_to_torch
    from vaw_torch.models.dit import DiT
    from vaw_tpu.models.dit import DiT as JaxDiT

    spec = dict(image_size=32, patch_size=2, in_channels=4, hidden_size=144, depth=2,
                num_heads=2, num_classes=10, class_dropout_prob=0.1)
    jmodel = JaxDiT(**spec)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 4)),
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, randomize(shapes, seed))
    model = DiT(**spec)
    model.load_state_dict(flax_dit_to_torch(params), strict=True)
    return jmodel, params, model.eval()


def test_small_dit_at_head_dim_72_matches_jax():
    """Forward and the gradient of sum(out * g) in f32 through every
    parameter and the input, port against the JAX package, at T = 256 and
    D = 72; weights carried by models/convert.py. Tolerances: the f32
    forward's atol 1e-4 (tests/test_torch_dit.py) and 1e-4 of each
    gradient's largest magnitude."""
    import jax
    import jax.numpy as jnp

    from vaw_torch.models.convert import flax_dit_to_torch

    jmodel, params, model = _dit_pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    y = np.array([1, 7], np.int32)
    g = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)

    def loss(p, xx):
        out, _ = jmodel.apply({"params": p}, xx, jnp.asarray(t), jnp.asarray(y))
        return jnp.sum(out * g), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(t), torch.from_numpy(y).long())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    (out * torch.from_numpy(g)).sum().backward()
    want_p = flax_dit_to_torch(jax.tree_util.tree_map(np.asarray, gp))
    got = dict(model.named_parameters())
    assert set(want_p) == set(got)
    for name, w in [("x", np.asarray(gx))] + [(k, v.numpy()) for k, v in want_p.items()]:
        have = xt.grad if name == "x" else got[name].grad
        peak = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(have.numpy(), w, atol=1e-4 * peak, rtol=0, err_msg=name)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [(2, 256, 16), (2, 258, 16)])
def test_cuda_d72_kernels_match_plain_versions(b, t, h):
    """The general forward and backward at D = 72 on a packed row's views
    (U-ViT-H/2's T = 258; at T = 256 the packed entry takes the p5 kernels,
    as the JAX gate does, so the views go to the general entry directly)
    and the fused entries (DiT-XL/2's T = 256): all wgmma, within 1e-2 (o)
    and 2e-2 of max|grad|, bit-equal when repeated."""
    _cuda()
    d = 72
    qkv, g = _qkv(b, t, h, d, seed=41)
    qkv, g = qkv.cuda().to(torch.bfloat16), g.cuda().to(torch.bfloat16)
    before = (dict(port_flash.flash_attention.launches_by_design),
              dict(port_flash.flash_attention_bwd.launches_by_design))
    x = qkv.detach().requires_grad_(True)
    out = flash_attention_packed(x) if t != 256 else flash_attention(*x.unbind(2))
    out.backward(g)
    again = torch.empty_like(qkv)
    o, lse = flash_attention_fwd(*qkv.unbind(2))
    flash_attention_bwd(*qkv.unbind(2), o, lse, g, grads=again.unbind(2))
    torch.cuda.synchronize()
    assert port_flash.flash_attention.launches_by_design["wgmma"] == before[0]["wgmma"] + 2
    assert port_flash.flash_attention_bwd.launches_by_design["wgmma"] == (
        before[1]["wgmma"] + 2)
    assert torch.equal(x.grad, again)
    want_o, want_lse = flash_attention_reference(*qkv.unbind(2))
    assert (out.float() - want_o.float()).abs().max() <= 1e-2
    want = flash_attention_bwd_reference(*qkv.unbind(2), o, lse, g)
    for got, w in zip(x.grad.unbind(2), want):
        assert (got.float() - w.float()).abs().max() <= 2e-2 * w.float().abs().max()
    if t != 256:
        return
    f = qkv.reshape(b, t, 3 * h * d)
    designs = (dict(flash_attention_fused.launches_by_design),
               dict(flash_attention_fused_bwd.launches_by_design))
    fo, flse = flash_attention_fused(f, h)
    d1 = flash_attention_fused_bwd(f, fo, flse, g.reshape(b, t, h * d), h)
    d2 = flash_attention_fused_bwd(f, fo, flse, g.reshape(b, t, h * d), h)
    torch.cuda.synchronize()
    assert flash_attention_fused.launches_by_design["wgmma"] == designs[0]["wgmma"] + 1
    assert flash_attention_fused_bwd.launches_by_design["wgmma"] == designs[1]["wgmma"] + 2
    assert flash_attention_fused.launches_by_design["mma_sync"] == designs[0]["mma_sync"]
    assert flash_attention_fused_bwd.launches_by_design["mma_sync"] == (
        designs[1]["mma_sync"])
    assert torch.equal(d1, d2)
    # The fused forward ran the general kernel on the same views.
    assert torch.equal(fo.view(b, t, h, d), o) and torch.equal(flse, lse)
    ro, _ = flash_attention_fused_reference(f, h)
    assert (fo.float() - ro.float()).abs().max() <= 1e-2
    rw = flash_attention_fused_bwd_reference(f, fo, flse, g.reshape(b, t, h * d), h)
    assert (d1.float() - rw.float()).abs().max() <= 2e-2 * rw.float().abs().max()


_FIRST_ON_AUTOGRAD = r"""
import sys
import torch
from vaw_torch.ops.flash_attention import flash_attention, flash_attention_packed
d = int(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(0)
qkv = torch.randn((2, 258, 3, 16, d), generator=g, device="cuda").to(torch.bfloat16)
dout = torch.randn((2, 258, 16, d), generator=g, device="cuda").to(torch.bfloat16)
x = qkv.detach().requires_grad_(True)
flash_attention_packed(x).backward(dout)
q, k, v = (t.detach().contiguous().requires_grad_(True) for t in qkv.unbind(2))
flash_attention(q, k, v).backward(dout)
torch.cuda.synchronize()
assert torch.isfinite(x.grad.float()).all() and torch.isfinite(q.grad.float()).all()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72])
def test_cuda_backward_as_the_first_work_of_autograds_thread(d):
    """A fresh process whose first work on autograd's worker thread is the
    general backward (PyTorch has made no context current there): the
    kernels encode their tensor maps all the same (hopper_common.cuh:
    make_tensor_map)."""
    _cuda()
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _FIRST_ON_AUTOGRAD, str(d)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
