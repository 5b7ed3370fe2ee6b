"""The bf16 wgmma forward's consumer warpgroups (vaw_torch/ops/
flash_attention.py: ``flash_fwd_consumers``) and the fused entry's route
onto that kernel, and the merged 3xTF32 backward pairs.

The fused forward's bf16 calls with scale > 0 run the general TMA + wgmma
forward (csrc/flash_fwd.cu) on the packed row's three views at every head
dim, with the number of consumer warpgroups the rule picks for Tq. The plan
builders read dtypes, devices, shapes and strides only, so they run on CPU
tensors here: the rule at each shape it was timed at, the fused plan's
views, offsets and count, and a signature's plan keeping its count. The
numbers are held against the JAX package's ``_flash_p6`` (Pallas in
interpret mode) on the CPU. The card's cases (marked ``cuda``; skipped
without a card) hold the route and both 3xTF32 backward pairs (csrc/
flash_bwd.cu and csrc/flash_p5_bwd.cu on hopper_common.cuh's shared loop)
against the plain versions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fused,
    flash_attention_fused_reference,
    flash_attention_fwd,
    flash_attention_p5_bwd,
    flash_attention_p5_bwd_reference,
    flash_attention_p5_fwd,
    flash_fwd_consumers,
)
from vaw_tpu.ops import flash_attention as jax_flash

# (Tq, padded D, consumers) at the shapes the rule was timed at (the models'
# bf16 calls at D <= 64, flash_attention.py's table): DiT-B/2's T = 256,
# U-ViT-L/2's and ViT-B/2's 258, MM-DiT-B/2's 257 (D = 32), LDM's 1024 and
# 64 (D = 32), ADM-64's 1024 and 64 (D = 64). LDM's 1024 takes two since
# its forward runs 128-key tiles.
TABLED = [(256, 64, 2), (258, 64, 3), (257, 32, 3), (1024, 32, 2), (64, 32, 3),
          (1024, 64, 2), (64, 64, 3)]


@pytest.mark.parametrize("tq,dp,want", TABLED)
def test_rule_at_each_timed_shape(tq, dp, want):
    assert flash_fwd_consumers(tq, dp) == want


@pytest.mark.parametrize("tq", [64, 256, 258, 1024, 4096])
@pytest.mark.parametrize("dp", [80, 128])
def test_wide_heads_take_two_consumers(tq, dp):
    """Above 64 columns the accumulators leave room for two warpgroups."""
    assert flash_fwd_consumers(tq, dp) == 2


@pytest.mark.parametrize("d,dp", [(8, 32), (32, 32), (40, 64), (64, 64), (72, 80),
                                  (80, 80), (96, 128), (128, 128)])
def test_head_dims_pad_as_the_kernel_pads(d, dp):
    assert port_flash._wgmma_dp(d) == dp


def _qkv2d(b, t, h, d, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, t, 3 * h * d), generator=gen).to(dtype)


@pytest.mark.parametrize("b,t,h,d", [(2, 256, 12, 64), (2, 258, 16, 64), (2, 257, 4, 32),
                                     (1, 64, 4, 40), (1, 1024, 2, 32), (2, 256, 4, 72)])
def test_fused_plan_runs_the_general_wgmma_forward_on_the_views(b, t, h, d):
    """A bf16 fused call with scale > 0 plans the general wgmma forward:
    the packed row's q, k and v as [B, T, H, D] views (their byte strides
    and offsets), T queries and keys, and the rule's consumer count."""
    qkv2d = _qkv2d(b, t, h, d)
    plan = port_flash._fused_fwd_plan(qkv2d, h, d ** -0.5)
    views = qkv2d.view(b, t, 3, h, d).unbind(2)
    assert plan.design == "wgmma"
    assert plan.dims == (b, t, t, h, d)
    assert plan.offsets == (0, 2 * h * d, 4 * h * d)
    assert list(plan.strides) == list(port_flash._map_strides(*views))
    dp = port_flash._wgmma_dp(d)
    assert plan.tail == (flash_fwd_consumers(t, dp), port_flash.flash_fwd_key_tile(t, t, dp))
    for view, offset in zip(views, plan.offsets):
        assert view.data_ptr() - qkv2d.data_ptr() == offset


@pytest.mark.parametrize("dtype,scale,design,tail", [
    (torch.bfloat16, -0.125, "mma_sync", (1,)), (torch.float32, 0.125, "tf32x3", ()),
    (torch.float32, -0.125, "fma", ())])
def test_other_fused_plans(dtype, scale, design, tail):
    """bf16 with scale <= 0 and f32 with scale > 0 also run the general
    kernels on the views; f32 with scale <= 0 the fused FMA kernel on
    qkv2d itself (no offsets, its own dims)."""
    b, t, h, d = 2, 256, 4, 64
    qkv2d = _qkv2d(b, t, h, d, dtype)
    plan = port_flash._fused_fwd_plan(qkv2d, h, scale)
    assert (plan.design, plan.tail) == (design, tail)
    if design == "fma":
        assert plan.offsets == () and plan.dims == (b, t, h, d) and plan.strides is None
    else:
        step = h * d * qkv2d.element_size()
        assert plan.offsets == (0, step, 2 * step) and plan.dims == (b, t, t, h, d)


def test_a_signatures_plan_keeps_its_count(monkeypatch):
    """The count is worked out once for a signature: the stored plan keeps
    it when the rule changes after (as when a probe forces a count), and a
    fresh plan of the same signature reads the rule anew."""
    qkv2d = _qkv2d(2, 256, 12, 64)
    key = ("fused_fwd", port_flash._signature(qkv2d), 12, True, port_flash.TF32X3_MIN_TILES)
    before = dict(port_flash._plans)
    try:
        stored = port_flash._remember(key, port_flash._fused_fwd_plan(qkv2d, 12, 0.125))
        assert stored.tail[0] == flash_fwd_consumers(256, 64)
        other = 5 - stored.tail[0]
        monkeypatch.setattr(port_flash, "flash_fwd_consumers", lambda tq, dp: other)
        assert port_flash._plans[key].tail == stored.tail
        assert port_flash._fused_fwd_plan(qkv2d, 12, 0.125).tail[0] == other
        q, k, v = qkv2d.view(2, 256, 3, 12, 64).unbind(2)
        assert port_flash._general_fwd_plan(q, k, v, 0.125).tail[0] == other
    finally:
        port_flash._plans.clear()
        port_flash._plans.update(before)


@pytest.mark.parametrize("b,t,h,d", [(2, 256, 2, 64), (2, 256, 4, 32), (1, 256, 16, 40)])
def test_cpu_route_matches_jax_p6(b, t, h, d):
    """The fused entry on CPU tensors (its plain version) against the JAX
    package's _flash_p6 forward on the same bf16-rounded inputs, at head
    dims the wgmma route takes as they are (64, 32) and pads (40 to 64):
    f32 math on both sides."""
    assert jax_flash.flash_fused_supported(b, h, d, t)
    rng = np.random.default_rng(7)
    f = torch.from_numpy((rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32))
    f = f.to(torch.bfloat16).float()
    want_o, (_, _, want_lse) = jax_flash._flash_p6_fwd(jnp.asarray(f.numpy()), h, d ** -0.5)
    got_o, got_lse = flash_attention_fused(f, h)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(b * h, t),
                               atol=1e-5)


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 12, 64), (3, 64, 4, 40)])
@pytest.mark.parametrize("consumers", [None, 2, 3])
def test_cuda_route_matches_plain(b, t, h, d, consumers, monkeypatch):
    """The fused bf16 forward on the general wgmma kernel, with the rule's
    count and with 2 and 3 forced, against the plain version: o within
    1e-2, lse within 1e-4, counted once under "wgmma"."""
    _cuda()
    if consumers is not None:
        monkeypatch.setattr(port_flash, "flash_fwd_consumers", lambda tq, dp: consumers)
    port_flash._plans.clear()
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv2d = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(flash_attention_fused.launches_by_design)
    try:
        o, lse = flash_attention_fused(qkv2d, h)
        torch.cuda.synchronize()
    finally:
        port_flash._plans.clear()
    assert flash_attention_fused.launches_by_design["wgmma"] == before["wgmma"] + 1
    ro, rlse = flash_attention_fused_reference(qkv2d, h)
    assert (o.float() - ro.float()).abs().max().item() <= 1e-2
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(4, 1024, 6, 64), (2, 77, 3, 32), (2, 300, 2, 40)])
def test_cuda_general_f32_pair_matches_plain(b, t, h, d):
    """The general 3xTF32 backward pair (GeneralTf on the shared loop) on
    packed views against the plain version, bit-equal when repeated."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
    dout = torch.randn((b, t, h, d), generator=gen, device="cuda")
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention_fwd(q, k, v)
    before = port_flash.flash_attention_bwd.launches_by_design["tf32x3"]
    grads = [torch.empty_like(qkv) for _ in range(2)]
    for g in grads:
        flash_attention_bwd(q, k, v, o, lse, dout, grads=g.unbind(2))
    torch.cuda.synchronize()
    assert port_flash.flash_attention_bwd.launches_by_design["tf32x3"] == before + 2
    assert torch.equal(grads[0], grads[1])
    want = torch.stack(flash_attention_bwd_reference(q, k, v, o, lse, dout), dim=2)
    err = (grads[0] - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(4, 256, 9, 64), (2, 256, 4, 32), (2, 256, 3, 40)])
def test_cuda_p5_f32_pair_matches_plain(b, t, h, d):
    """The d-major 3xTF32 backward pair (P5Tf on the shared loop) against
    the plain version, bit-equal when repeated."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    f5 = torch.randn((b, 3, h, d, t), generator=gen, device="cuda")
    dout = torch.randn((b * h, d, t), generator=gen, device="cuda")
    o, lse = flash_attention_p5_fwd(f5)
    before = port_flash.flash_attention_p5_bwd.launches_by_design["tf32x3"]
    got = [flash_attention_p5_bwd(f5, o, lse, dout) for _ in range(2)]
    torch.cuda.synchronize()
    assert port_flash.flash_attention_p5_bwd.launches_by_design["tf32x3"] == before + 2
    assert torch.equal(got[0], got[1])
    want = flash_attention_p5_bwd_reference(f5, o, lse, dout)
    err = (got[0] - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item())
