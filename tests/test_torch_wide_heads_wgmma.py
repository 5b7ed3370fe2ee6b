"""Head dims 96 and 128 on the TMA + wgmma attention backwards: the general
pair (csrc/flash_bwd.cu; ViT-S's 128, UNet-64's 96 at T = 64, and the fused
entry's bf16 calls on the packed row's views) and the d-major p5 pair
(csrc/flash_p5_bwd.cu; UNet-64's 96 at T = 256, DiT-XL/2's 72 under
VAW_FUSED_TMAJOR=0).

The kernels cannot run here, so a plain-torch emulation of their tiling
stands in for them on the CPU: the head dim padded as the kernels pad it
(the general pair to 96 or 128 columns, TMA's zero fill past D; the p5 pair
to D rounded up to 16 rows of d), products in 16-deep steps, 128-query dQ
items against 64-key tiles, 64-key dK/dV items (warpgroup 0 accumulating
dV, warpgroup 1 dK, each over all columns) against 64-query tiles, and P
and dS entering their products as one bf16 term in the general pair
(flash_bwd.cu:kBwdTerms) and as bf16 hi + lo halves in the p5 pair.
It is held against
the plain versions and against the JAX package's Pallas kernels in
interpret mode (_flash at (1, 258, 2, 128) and (1, 64, 4, 96), _flash_p5 at
(1, 256, 4, 96)), on inputs rounded to bf16, within the bf16 tolerance
tests/test_ops.py:340 holds the Pallas kernels to: atol and rtol 2e-2. The
routing rules, a small ViT with 128-wide heads and a small UNet with
96-wide heads against the JAX package's, and the card's cases (marked
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
from _torch_bwd_terms import bwd_terms

from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_p5_bwd,
    flash_attention_p5_bwd_reference,
    flash_attention_p5_fwd,
    flash_attention_packed,
    flash_attention_reference,
    flash_bwd_design,
    flash_fused_bwd_design,
    flash_p5_bwd_design,
)

BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_ops.py:340
DQ_ITEM, DKV_ITEM, TILE, STEP = 128, 64, 64, 16
LOG2E = 1.0 / math.log(2.0)


def general_pad(d: int) -> int:
    """The general pair's padded head dim: 32, 64, 80, 96 or 128
    (flash_bwd.cu:vaw_flash_bwd_wgmma)."""
    return next(p for p in (32, 64, 80, 96, 128) if d <= p)


def p5_pad(d: int) -> int:
    """The p5 pair's rows of d: D rounded up to 16 (flash_p5_bwd.cu)."""
    return -(-d // 16) * 16


def _bf16(shape, rng, scale=1.0):
    """Seeded normal values rounded to bf16, held in f32."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).float()


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return _bf16((b, t, 3, h, d), rng, 0.5), _bf16((b, t, h, d), rng)


def _split(p):
    """P -> its bf16 hi half (P cut to bf16) and lo half (bf16(P - hi))."""
    hi = (p.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).float()


def _depth_steps(a, b):
    """a b^T over the head dim in 16-deep steps, summed in f32."""
    return sum(a[..., c:c + STEP] @ b[..., c:c + STEP].transpose(-1, -2)
               for c in range(0, a.shape[-1], STEP))


def _width_steps(halves, x):
    """sum over halves of h x, 16 rows of x (keys or queries) a step."""
    return sum(h[..., r:r + STEP] @ x[..., r:r + STEP, :]
               for h in halves for r in range(0, h.shape[-1], STEP))


def emulate_bwd(q, k, v, out, lse, dout, scale, pad, p5=False):
    """The backward pair's arithmetic over a head dim padded to `pad` with
    zero columns. The dQ kernel: 128-query items, delta = rowsum(dout * out)
    in f32, per 64-key tile S and dP in 16-deep steps, P = exp2(S scale
    log2(e) - lse2), dS = P (dP - delta), dQ += dS k with dS in its bf16
    terms, dQ scaled at the end. The dK/dV kernel: 64-key items, one
    warpgroup accumulating dV += P^T dout, the other dK += dS^T q, each over
    all `pad` columns with P^T or dS^T in their bf16 terms, per 64-query
    tile; dK scaled at the end. The terms: hi + lo in the p5 pair (`p5`),
    the general pair's kBwdTerms otherwise. q, k, v, out, dout [B, T,
    H, D]; returns dq, dk, dv [B, T, H, pad] f32."""
    if p5 or bwd_terms() == 2:
        terms = _split
    else:
        terms = lambda x: (x.to(torch.bfloat16).float(),)  # noqa: E731
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qh, kh, vh, oh, doh = (F.pad(x.transpose(1, 2), (0, pad - d))
                           for x in (q, k, v, out, dout))
    sl = scale * LOG2E
    lse2 = (lse.reshape(b, h, tq) * LOG2E)[..., None]
    delta = (doh * oh).sum(-1, keepdim=True)
    dq = torch.zeros(b, h, tq, pad)
    for q0 in range(0, tq, DQ_ITEM):
        rows = slice(q0, q0 + DQ_ITEM)
        acc = 0.0
        for k0 in range(0, tk, TILE):
            keys = slice(k0, k0 + TILE)
            s = _depth_steps(qh[:, :, rows], kh[:, :, keys])
            dp = _depth_steps(doh[:, :, rows], vh[:, :, keys])
            ds = torch.exp2(s * sl - lse2[:, :, rows]) * (dp - delta[:, :, rows])
            acc = acc + _width_steps(terms(ds), kh[:, :, keys])
        dq[:, :, rows] = acc * scale
    dk, dv = torch.zeros(b, h, tk, pad), torch.zeros(b, h, tk, pad)
    for k0 in range(0, tk, DKV_ITEM):
        keys = slice(k0, k0 + DKV_ITEM)
        acc_k, acc_v = 0.0, 0.0
        for j0 in range(0, tq, TILE):
            rows = slice(j0, j0 + TILE)
            # Each warpgroup computes S^T itself; the dK one also dP^T.
            pt = torch.exp2(_depth_steps(kh[:, :, keys], qh[:, :, rows]) * sl
                            - lse2[:, :, rows].transpose(-1, -2))
            acc_v = acc_v + _width_steps(terms(pt), doh[:, :, rows])
            dpt = _depth_steps(vh[:, :, keys], doh[:, :, rows])
            dst = pt * (dpt - delta[:, :, rows].transpose(-1, -2))
            acc_k = acc_k + _width_steps(terms(dst), qh[:, :, rows])
        dk[:, :, keys], dv[:, :, keys] = acc_k * scale, acc_v
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, dtype=np.float32),
                               err_msg=what, **BF16_TOL)


def _bf16_out(q, k, v):
    """The forward's o rounded to bf16 (as the kernels store it) and lse."""
    o, lse = flash_attention_reference(q, k, v)
    return o.to(torch.bfloat16).float(), lse


@pytest.mark.parametrize("b,t,h,d,pad", [(1, 258, 2, 128, 128), (2, 64, 3, 96, 96),
                                         (1, 136, 2, 88, 96), (1, 256, 2, 96, 96),
                                         (1, 256, 2, 72, 80), (1, 256, 2, 112, 112)])
def test_emulated_tiling_matches_the_plain_versions(b, t, h, d, pad):
    """The tiling at each padded width (the general pair's 96 and 128; the
    p5 pair's 80, 96 and 112 rows of d) against the plain backward on the
    same bf16-valued inputs; every gradient's pad columns are zero."""
    qkv, g = _qkv(b, t, h, d, seed=t + d)
    q, k, v = qkv.unbind(2)
    out, lse = _bf16_out(q, k, v)
    grads = emulate_bwd(q, k, v, out, lse, g, d ** -0.5, pad, p5=t == 256)
    for name, got, want in zip(("dq", "dk", "dv"), grads,
                               flash_attention_bwd_reference(q, k, v, out, lse, g)):
        assert torch.equal(got[..., d:], torch.zeros_like(got[..., d:])), name
        _close(got[..., :d], want, name)


@pytest.mark.parametrize("b,t,h,d", [(1, 258, 2, 128), (1, 64, 4, 96)])
def test_emulated_tiling_matches_pallas_flash_interpret(b, t, h, d):
    """ViT-S's head dim of 128 at T = 258 and UNet-64's 96 at its 8x8 level
    (T = 64): the emulated general tiling against the JAX package's _flash
    backward (jax.grad through its custom_vjp), in interpret mode."""
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    qkv, g = _qkv(b, t, h, d, seed=31 + d)
    q, k, v = qkv.unbind(2)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    want = jax.grad(lambda a, b_, c: jnp.sum(jax_flash.flash_attention(a, b_, c) * g.numpy()),
                    argnums=(0, 1, 2))(jq, jk, jv)
    out, lse = _bf16_out(q, k, v)
    for name, got, w in zip(("dq", "dk", "dv"),
                            emulate_bwd(q, k, v, out, lse, g, d ** -0.5, general_pad(d)),
                            want):
        _close(got[..., :d], w, name)


def test_emulated_tiling_matches_pallas_p5_interpret():
    """UNet-64's 16x16 level at (1, 256, 4, 96): the emulated p5 tiling
    (96 rows of d) against the JAX package's _flash_p5 backward, in
    interpret mode, on the d-major f5 [B, 3, H, D, T]."""
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    b, t, h, d = 1, 256, 4, 96
    assert jax_flash._packed5_supported(b, h, d, t)
    qkv, g = _qkv(b, t, h, d, seed=51)
    f5 = qkv.permute(0, 2, 3, 4, 1).contiguous()            # [B, 3, H, D, T]
    g5 = g.permute(0, 2, 3, 1).reshape(b * h, d, t)          # [B*H, D, T]
    scale = d ** -0.5
    _, res = jax_flash._flash_p5_fwd(jnp.asarray(f5.numpy()), scale)
    (want,) = jax_flash._flash_p5_bwd(scale, res, jnp.asarray(g5.numpy()))
    q, k, v = qkv.unbind(2)
    out, lse = _bf16_out(q, k, v)
    got = torch.stack(emulate_bwd(q, k, v, out, lse, g, scale, p5_pad(d), p5=True), dim=1)
    _close(got[..., :d].permute(0, 1, 3, 4, 2), want, "dqkv")


@pytest.mark.parametrize("d", [88, 96, 128])
def test_bf16_wide_head_dims_take_wgmma(d):
    """bf16 with scale > 0 at D = 88, 96 and 128: both backwards' wgmma
    designs, the general one also on a packed row's mapped views and
    through the fused entry's rule."""
    views = tuple(torch.zeros(2, 64, 3, 4, d, dtype=torch.bfloat16).unbind(2))
    scale = d ** -0.5
    assert flash_bwd_design(torch.bfloat16, d, scale) == "wgmma"
    assert flash_bwd_design(torch.bfloat16, d, scale, views * 2) == "wgmma"
    assert flash_fused_bwd_design(torch.bfloat16, d, scale, views * 2) == "wgmma"
    assert flash_p5_bwd_design(torch.bfloat16, d, scale) == "wgmma"


@pytest.mark.parametrize("dtype,d,scale,general,p5", [
    (torch.float32, 96, 96 ** -0.5, "fma", "fma"),     # f32 above 64 keeps the FMAs
    (torch.float32, 128, 128 ** -0.5, "fma", "fma"),
    (torch.bfloat16, 96, -0.3, "mma_sync", "mma_sync"),
    (torch.bfloat16, 128, 0.0, "mma_sync", "mma_sync"),
    (torch.bfloat16, 136, 0.3, "mma_sync", None)])    # past the wgmma pair's 128
def test_other_wide_head_calls_keep_their_kernels(dtype, d, scale, general, p5):
    assert flash_bwd_design(dtype, d, scale) == general
    if p5 is not None:
        assert flash_p5_bwd_design(dtype, d, scale) == p5


def test_expanded_views_keep_the_mma_sync_pair_at_d128():
    """A stride-0 k (no tensor map) sends a D = 128 call to mma.sync."""
    q = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, 128, dtype=torch.bfloat16).expand(1, 64, 2, 128)
    assert flash_bwd_design(torch.bfloat16, 128, 0.1, (q, k, k, q, q, q)) == "mma_sync"


def _randomize(params, seed):
    """Seeded numpy noise in place of every leaf: kernels ~ 1/sqrt(fan_in),
    norm scales ~ 1 + 0.1 N, tables ~ 0.3, biases ~ 0.05."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.standard_normal(p.shape)
        if name == "kernel":
            return (z / np.sqrt(np.prod(p.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * z).astype(np.float32)
        std = 0.3 if name in ("embedding", "pos_embed") else 0.05
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _grads_close(jmodel, params, model, to_torch, x, t, y, seed):
    """Forward and the gradient of sum(out * g) in f32 through every
    parameter, port against the JAX package on the same weights. The f32
    forward within atol 1e-4 of max|out| and each gradient within 1e-4 of
    its largest magnitude (f32 both sides, summed in other orders)."""
    import jax
    import jax.numpy as jnp

    g = np.random.default_rng(seed).standard_normal(x.shape).astype(np.float32)

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * g), out

    (_, want), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    out = out[0] if isinstance(out, tuple) else out
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    (out * torch.from_numpy(g)).sum().backward()
    want_p = to_torch(jax.tree_util.tree_map(np.asarray, gp))
    got = dict(model.named_parameters())
    assert set(want_p) == set(got)
    for name, w in want_p.items():
        peak = max(np.abs(w.numpy()).max(), 1e-6)
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(), atol=1e-4 * peak,
                                   rtol=0, err_msg=name)


def test_small_vit_with_128_wide_heads_matches_jax():
    """A ViT with ViT-S's head dim (embed 256, 2 heads of 128, depth 2,
    8x8x4 images, patch 2: T = 18): forward and parameter gradient against
    the JAX package's, weights carried by models/convert.py."""
    import jax
    import jax.numpy as jnp

    from vaw_torch.models.convert import flax_vit_to_torch
    from vaw_torch.models.vit import ViT
    from vaw_tpu.models.vit import ViT as JaxViT

    spec = dict(image_size=8, patch_size=2, in_channels=4, embed_dim=256, depth=2,
                num_heads=2, num_classes=10, drop_label_prob=0.1)
    jmodel = JaxViT(**spec)
    params = _randomize(jmodel.init(jax.random.key(0), jnp.zeros((2, 8, 8, 4)),
                                    jnp.zeros((2,)), jnp.zeros((2,), jnp.int32))["params"], 3)
    model = ViT(**spec)
    model.load_state_dict(flax_vit_to_torch(params), strict=True)
    assert spec["embed_dim"] // spec["num_heads"] == 128
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    _grads_close(jmodel, params, model.eval(), flax_vit_to_torch, x,
                 np.array([3.0, 700.0], np.float32), np.array([1, 7], np.int32), 5)


def test_small_unet_with_96_wide_heads_matches_jax():
    """A UNet with UNet-64's head dim (96 channels, one head a block,
    num_head_channels=-1, attention at 16x16 and 8x8 of 16x16x4 inputs:
    the p5 route at T = 256 and the general route at T = 64, each 96 wide):
    forward and parameter gradient against the JAX package's, weights
    carried by models/convert.py."""
    import jax
    import jax.numpy as jnp

    from vaw_torch.models import unet as port_unet
    from vaw_torch.models.convert import flax_unet_to_torch
    from vaw_tpu.models.unet import UNetModel as JaxUNet

    spec = dict(image_size=16, in_channels=4, model_channels=96, out_channels=4,
                num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 1),
                num_heads=1, num_head_channels=-1, num_classes=10, drop_label_prob=0.1)
    jmodel = JaxUNet(**spec)
    params = _randomize(jmodel.init(jax.random.key(0), jnp.zeros((1, 16, 16, 4)),
                                    jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"], 6)
    model = port_unet.UNetModel(**spec)
    model.load_state_dict(flax_unet_to_torch(params, model), strict=True)
    calls = []
    real_p5, real_general = port_flash._FlashP5.apply, port_flash._FlashPacked.apply
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_flash._FlashP5, "apply",
                   lambda *a: calls.append(("p5", a[0].shape)) or real_p5(*a))
        mp.setattr(port_flash._FlashPacked, "apply",
                   lambda *a: calls.append(("general", a[0].shape)) or real_general(*a))
        _grads_close(jmodel, params, model.eval(),
                     lambda p: flax_unet_to_torch(p, model), x,
                     np.array([3.0, 700.0], np.float32), np.array([1, 7], np.int32), 8)
    assert ("p5", (2, 3, 1, 96, 256)) in calls and ("general", (2, 64, 3, 1, 96)) in calls


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(2, 258, 4, 128), (2, 64, 4, 96), (2, 136, 3, 88),
                                     (3, 200, 2, 112), (2, 77, 2, 104)])
def test_cuda_general_wide_heads_match_plain_versions(b, t, h, d):
    """The general backward at D = 88-128 on a packed row's views: on
    wgmma (counted), within 2e-2 of max|grad| of the plain version,
    bit-equal when repeated."""
    _cuda()
    qkv, g = _qkv(b, t, h, d, seed=61)
    qkv, g = qkv.cuda().to(torch.bfloat16), g.cuda().to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention_fwd(q, k, v)
    before = dict(port_flash.flash_attention_bwd.launches_by_design)
    got, again = torch.empty_like(qkv), torch.empty_like(qkv)
    flash_attention_bwd(q, k, v, o, lse, g, grads=got.unbind(2))
    flash_attention_bwd(q, k, v, o, lse, g, grads=again.unbind(2))
    torch.cuda.synchronize()
    before["wgmma"] += 2
    assert port_flash.flash_attention_bwd.launches_by_design == before
    assert torch.equal(got, again)
    for x, w in zip(got.unbind(2), flash_attention_bwd_reference(q, k, v, o, lse, g)):
        assert (x.float() - w.float()).abs().max() <= 2e-2 * w.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,d", [(2, 4, 96), (2, 2, 72), (2, 2, 80), (2, 3, 112),
                                   (2, 2, 128)])
def test_cuda_p5_wide_heads_match_plain_versions(b, h, d):
    """The p5 backward at D = 72-128 (T = 256): on wgmma (counted), within
    2e-2 of max|grad| of the plain version, bit-equal when repeated; the
    packed entry's autograd at D = 96 takes it too."""
    _cuda()
    qkv, g = _qkv(b, 256, h, d, seed=71)
    f5 = qkv.permute(0, 2, 3, 4, 1).contiguous().cuda().to(torch.bfloat16)
    g5 = g.permute(0, 2, 3, 1).reshape(b * h, d, 256).contiguous().cuda().to(torch.bfloat16)
    o, lse = flash_attention_p5_fwd(f5)
    before = dict(port_flash.flash_attention_p5_bwd.launches_by_design)
    got = flash_attention_p5_bwd(f5, o, lse, g5)
    again = flash_attention_p5_bwd(f5, o, lse, g5)
    torch.cuda.synchronize()
    before["wgmma"] += 2
    assert port_flash.flash_attention_p5_bwd.launches_by_design == before
    assert torch.equal(got, again)
    want = flash_attention_p5_bwd_reference(f5, o, lse, g5)
    for j in range(3):
        w = want[:, j].float()
        assert (got[:, j].float() - w).abs().max() <= 2e-2 * w.abs().max()
    if d != 96:
        return
    x = qkv.cuda().to(torch.bfloat16).requires_grad_(True)
    n = port_flash.flash_attention_p5_bwd.launches_by_design["wgmma"]
    flash_attention_packed(x).backward(g.cuda().to(torch.bfloat16))
    torch.cuda.synchronize()
    assert port_flash.flash_attention_p5_bwd.launches_by_design["wgmma"] == n + 1
