"""Parity of the port's general-T attention (vaw_torch/ops/flash_attention.py:
flash_attention, flash_attention_packed and their plain versions) with the
JAX package's _flash, whose Pallas kernels (_fwd_kernel, _bwd_kernel) run in
interpret mode on the CPU. Inputs and incoming gradients come from numpy
with a fixed seed; shapes cover T in {18, 258, 300}, Tq != Tk and
D in {8, 72, 256}.

Tolerances:
- forward against the Pallas forward: atol 2e-5, the bound
  tests/test_ops.py:43 holds the Pallas kernel to (f32 on both sides,
  different summation order);
- gradients against jax.grad through the Pallas kernels: atol 5e-5, the
  bound of tests/test_ops.py:69;
- the plain backward against autograd of the plain forward: atol 1e-5 (the
  same f32 math, P from lse instead of softmax);
- the CUDA kernels against the plain versions on the card: forward f32 atol
  2e-5 and bf16 atol 1e-2 (one bf16 rounding of |o| < 2), lse atol 1e-4;
  backward f32 within 1e-4 and bf16 within 2e-2 of max|grad| (P and dS enter
  the wgmma pair's tensor-core products as one bf16 term, rounded once,
  flash_bwd.cu:kBwdTerms; the mma.sync kernels' as bf16 hi + lo;
  each gradient is rounded once to bf16); a repeated backward is bit-equal
  (no atomics);
- the wgmma pair's one term: each output's root mean square error against
  the f32 plain version on the same bf16 inputs at most 1.5 times SDPA's
  (the max error, mostly the output's own bf16 rounding, is printed, not
  gated).

The bf16 kernels are chosen by the call (``flash_fwd_design``,
``flash_bwd_design``): the TMA + wgmma ones for D <= 128 with scale > 0,
mma.sync otherwise; the CPU tests check
that choice, the tensor maps the wgmma kernels are given, and that every
bf16 general call of U-ViT-L/2, LDM and ADM-64 takes wgmma.

JAX is imported inside the tests that compare with it, so the CUDA cases
also collect on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vaw_torch.ops import attention as port_attention
from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    KERNEL_DESIGNS,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_reference,
    flash_bwd_design,
    flash_fwd_design,
    general_tensor_map,
)

# (B, Tq, Tk, H, D)
SHAPES = [(2, 18, 18, 2, 8), (1, 258, 258, 2, 72), (1, 77, 300, 2, 256),
          (2, 300, 18, 1, 8)]


def _inputs(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, tq, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, tk, h, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    g = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES)
def test_forward_matches_pallas_interpret(b, tq, tk, h, d):
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    q, k, v, _ = _inputs(b, tq, tk, h, d)
    want = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (b, tq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES)
def test_grads_match_jax_grad_through_pallas(b, tq, tk, h, d):
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    q, k, v, g = _inputs(b, tq, tk, h, d, seed=1)
    want = jax.grad(lambda *a: jnp.sum(jax_flash.flash_attention(*a) * g),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (flash_attention(*xs) * torch.from_numpy(g)).sum().backward()
    for x, w, name in zip(xs, want, "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=5e-5, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b,t,h,d", [(2, 258, 2, 64), (1, 18, 3, 8)])
def test_packed_matches_pallas_packed(b, t, h, d):
    import jax
    import jax.numpy as jnp

    from vaw_tpu.ops import flash_attention as jax_flash

    rng = np.random.default_rng(2)
    qkv = (rng.standard_normal((b, t, 3, h, d)) * 0.5).astype(np.float32)
    g = rng.standard_normal((b, t, h, d)).astype(np.float32)
    assert not jax_flash._packed5_supported(b, h, d, t)  # the JAX side runs _flash
    want_o = jax_flash.flash_attention_packed(jnp.asarray(qkv))
    want_g = jax.grad(lambda x: jnp.sum(jax_flash.flash_attention_packed(x) * g))(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = flash_attention_packed(x)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), atol=2e-5, rtol=0)
    assert x.grad.shape == x.shape
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=5e-5, rtol=0)


@pytest.mark.parametrize("b,h,d", [(8, 12, 64), (2, 4, 128)])
def test_packed_refuses_the_p5_shapes(b, h, d, monkeypatch):
    """The general kernels refuse the shapes where the JAX package runs its
    d-major packed kernel: the packed entry hands those to the p5 route
    (tests/test_torch_flash_attention_p5.py), and these only."""
    from vaw_tpu.ops import flash_attention as jax_flash

    from vaw_torch.ops import flash_attention as port_flash

    routes = []
    for name in ("_FlashP5", "_FlashPacked"):
        real = getattr(port_flash, name).apply
        monkeypatch.setattr(getattr(port_flash, name), "apply",
                            lambda *a, name=name, real=real: routes.append(name) or real(*a))
    assert jax_flash._packed5_supported(b, h, d, 256)
    assert not jax_flash._packed5_supported(b, h, d, 255)
    assert flash_attention_packed(torch.zeros(b, 256, 3, h, d)).shape == (b, 256, h, d)
    assert flash_attention_packed(torch.zeros(b, 255, 3, h, d)).shape == (b, 255, h, d)
    assert routes == ["_FlashP5", "_FlashPacked"]


@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES[:3])
def test_bwd_reference_matches_autograd_of_plain_forward(b, tq, tk, h, d):
    q, k, v, g = _inputs(b, tq, tk, h, d, seed=3)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = flash_attention_reference(*xs, 0.37)  # plain autograd graph
    (out * torch.from_numpy(g)).sum().backward()
    got = flash_attention_bwd_reference(*(x.detach() for x in xs), out.detach(),
                                        lse.detach(), torch.from_numpy(g), 0.37)
    for grad, x in zip(got, xs):
        assert grad.shape == x.shape and grad.dtype == torch.float32
        np.testing.assert_allclose(grad.numpy(), x.grad.numpy(), atol=1e-5, rtol=0)


def test_router_sends_any_t_the_kernel_takes_to_it(monkeypatch):
    calls = []
    monkeypatch.setattr(port_attention, "flash_attention_packed",
                        lambda qkv, scale=None, d_major_out=False:
                        calls.append(qkv.shape[1]) or qkv[:, :, 0])
    for t in (5, 258, 4096):
        port_attention.multi_head_attention_packed(torch.zeros(1, t, 3, 1, 8))
    # D = 12 (not a multiple of 8) and 4097 keys go to the plain math.
    q, k, v, _ = _inputs(1, 9, 9, 2, 12, seed=4)
    want = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))[0]
    got = port_attention.multi_head_attention_packed(
        torch.from_numpy(np.stack([q, k, v], axis=2)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    port_attention.multi_head_attention_packed(torch.zeros(1, 4097, 3, 1, 8))
    assert calls == [5, 258, 4096]


def test_plain_route_matches_jax_xla_attention():
    """A shape the kernel does not take (D = 12) goes to the plain math, as
    the JAX package's goes to XLA."""
    import jax.numpy as jnp

    from vaw_tpu.ops.attention import _xla_attention

    q, k, v, _ = _inputs(2, 20, 33, 3, 12, seed=5)
    want = _xla_attention(*(jnp.asarray(a) for a in (q, k, v)), 0.3)
    got = port_attention.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                              0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_cpu_launches_no_kernel():
    before = (flash_attention.launches, flash_attention_bwd.launches)
    q, k, v, g = _inputs(1, 40, 50, 2, 16, seed=6)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (flash_attention(*xs) * torch.from_numpy(g)).sum().backward()
    assert all(x.grad is not None for x in xs)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def test_wrappers_reject_malformed_input():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 16, 16, 2, 8, seed=7))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :, :1], v)
    out, lse = flash_attention_reference(q, k, v)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse, g, grads=(q, k[:1], v))
    with pytest.raises(ValueError):
        flash_attention_packed(torch.zeros(2, 16, 2, 2, 8))


@pytest.mark.parametrize("dtype,d,scale,design", [
    (torch.bfloat16, 32, 32 ** -0.5, "wgmma"), (torch.bfloat16, 64, 0.125, "wgmma"),
    (torch.bfloat16, 128, 0.3, "wgmma"), (torch.bfloat16, 136, 0.3, "mma_sync"),
    (torch.bfloat16, 256, 0.0625, "mma_sync"), (torch.bfloat16, 64, -0.3, "mma_sync"),
    (torch.bfloat16, 32, 0.0, "mma_sync"), (torch.float32, 32, 0.3, "tf32x3"),
    (torch.float32, 64, 0.125, "tf32x3"), (torch.float32, 256, -0.3, "fma")])
def test_forward_design_is_chosen_by_the_call(dtype, d, scale, design):
    """For D <= 128 with a positive scale (the softmax takes the max on the
    raw scores) bf16 takes the TMA + wgmma forward and f32 its 3xTF32
    design on the same pipeline; otherwise bf16 takes mma.sync and f32 the
    FMA kernel."""
    assert flash_fwd_design(dtype, d, scale) == design


@pytest.mark.parametrize("dtype,d,scale,design", [
    (torch.bfloat16, 32, 32 ** -0.5, "wgmma"), (torch.bfloat16, 64, 0.125, "wgmma"),
    (torch.bfloat16, 8, 0.3, "wgmma"), (torch.bfloat16, 72, 0.3, "wgmma"),
    (torch.bfloat16, 128, 0.3, "wgmma"), (torch.bfloat16, 136, 0.3, "mma_sync"),
    (torch.bfloat16, 256, 0.0625, "mma_sync"), (torch.bfloat16, 64, -0.3, "mma_sync"),
    (torch.float32, 32, 0.3, "tf32x3"), (torch.float32, 256, 0.0625, "fma")])
def test_backward_design_is_chosen_by_the_call(dtype, d, scale, design):
    """With a positive scale bf16 takes the TMA + wgmma backward for D <=
    128 (D = 72 pads to 80; from 96 the dK/dV kernel gives dV and dK a
    warpgroup each) and f32 its 3xTF32 design for D <= 64
    (no views given: the crossover is not ruled on); otherwise bf16 takes
    mma.sync and f32 the FMA kernels."""
    assert flash_bwd_design(dtype, d, scale) == design


def test_design_of_a_view_without_a_tensor_map_is_mma_sync():
    """A bf16 call with a view TMA cannot map (k expanded over the heads, a
    stride of 0) goes, by the call, to the mma.sync kernels; f32 to the FMA
    kernels (the 3xTF32 forward reads through tensor maps too)."""
    q = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 1, 64, dtype=torch.bfloat16).expand(2, 16, 4, 64)
    assert flash_fwd_design(torch.bfloat16, 64, 0.125, (q, q, q)) == "wgmma"
    assert flash_fwd_design(torch.bfloat16, 64, 0.125, (q, k, k)) == "mma_sync"
    assert flash_bwd_design(torch.bfloat16, 64, 0.125, (q,) * 6) == "wgmma"
    assert flash_bwd_design(torch.bfloat16, 64, 0.125, (q, k, k, q, q, q)) == "mma_sync"
    assert flash_fwd_design(torch.float32, 64, 0.125, (q, k, k)) == "fma"
    assert flash_bwd_design(torch.float32, 64, 0.125, (q, k, k, q, q, q)) == "fma"


def _uvit_l():
    from vaw_torch.models.uvit import UViT_L
    return UViT_L(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                  class_dropout_prob=0.1, compute_dtype=torch.bfloat16), (32, 32, 4)


def _ldm():
    from vaw_torch.models.unet import LDM
    return LDM(num_classes=1000, in_channels=4, drop_label_prob=0.1,
               compute_dtype=torch.bfloat16), (32, 32, 4)


def _adm64():
    from vaw_torch.models.unet import ADM_64
    return ADM_64(num_classes=1000, in_channels=3, drop_label_prob=0.1,
                  compute_dtype=torch.bfloat16), (64, 64, 3)


@pytest.mark.parametrize("build,calls,shapes", [
    (_uvit_l, 21, {(8, 258, 3, 16, 64)}),
    (_ldm, 11, {(8, 1024, 3, 8, 32), (8, 64, 3, 32, 32)}),
    (_adm64, 22, {(8, 1024, 3, 6, 64), (8, 256, 3, 9, 64), (8, 64, 3, 12, 64)})],
    ids=["U-ViT-L/2", "LDM", "ADM-64"])
def test_model_general_calls_take_the_wgmma_kernels(build, calls, shapes):
    """Every general attention call of one bf16 forward of the three models
    that run the general kernels, recorded on the meta device at batch 8
    (ADM-64's nine heads at T = 256 take the p5 kernels only at B in {1, 2,
    4}), goes to the TMA + wgmma forward and backward."""
    recorded = []

    def record(qkv, scale):
        recorded.append((tuple(qkv.shape), qkv.dtype, scale))
        return qkv[:, :, 0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_flash._FlashPacked, "apply", record)
        mp.setattr(port_flash, "flash_attention_p5",
                   lambda f5, scale: f5.new_empty((f5.shape[0] * f5.shape[2],
                                                   *f5.shape[3:])))
        with torch.device("meta"):
            model, image = build()
            model(torch.empty(8, *image), torch.empty(8), torch.zeros(8, dtype=torch.long))
    assert len(recorded) == calls
    assert {shape for shape, _, _ in recorded} == shapes
    for shape, dtype, scale in recorded:
        assert dtype == torch.bfloat16
        assert flash_fwd_design(dtype, shape[-1], scale) == "wgmma"
        assert flash_bwd_design(dtype, shape[-1], scale) == "wgmma"


def test_tensor_map_of_a_contiguous_tensor():
    x = torch.zeros(2, 5, 3, 8, dtype=torch.bfloat16)
    assert general_tensor_map(x) == ((8, 3, 5, 2), (16, 48, 240))
    y = torch.zeros(4, 258, 16, 64, dtype=torch.bfloat16)
    assert general_tensor_map(y) == ((64, 16, 258, 4), (128, 2048, 528384))


def test_tensor_map_of_the_packed_views():
    """q, k and v of one packed [B, T, 3, H, D] share its strides: the token
    stride is a whole packed row, the head stride D."""
    qkv = torch.zeros(2, 258, 3, 16, 64, dtype=torch.bfloat16)
    row = 3 * 16 * 64 * 2
    for x in qkv.unbind(2):
        assert general_tensor_map(x) == ((64, 16, 258, 2), (128, row, 258 * row))
    assert qkv[:, :, 1].data_ptr() - qkv.data_ptr() == 16 * 64 * 2


def test_tensor_map_refuses_what_tma_does_not_take():
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        general_tensor_map(torch.zeros(1, 16, 2, 12, dtype=torch.bfloat16))  # 24-byte heads
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        general_tensor_map(torch.zeros(1, 16, 2, 12, dtype=torch.bfloat16)[..., :8])
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        general_tensor_map(torch.zeros(1, 16, 1, 8, dtype=torch.bfloat16).expand(1, 16, 4, 8))
    with pytest.raises(ValueError, match="unit stride over D"):
        general_tensor_map(torch.zeros(1, 16, 8, 2, dtype=torch.bfloat16).transpose(2, 3))
    with pytest.raises(ValueError, match=r"\[B, T, H, D\]"):
        general_tensor_map(torch.zeros(16, 2, 8, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_counts_no_launch_by_design(dtype):
    before = (dict(flash_attention.launches_by_design),
              dict(flash_attention_bwd.launches_by_design))
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs(1, 40, 50, 2, 32, seed=10))
    xs = [x.requires_grad_(True) for x in (q, k, v)]
    (flash_attention(*xs) * g).sum().backward()
    assert all(x.grad is not None for x in xs)
    assert (flash_attention.launches_by_design,
            flash_attention_bwd.launches_by_design) == before
    assert set(before[0]) == set(before[1]) == set(KERNEL_DESIGNS)


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


CUDA_SHAPES = [(2, 258, 258, 16, 64), (2, 77, 300, 3, 64), (1, 300, 77, 2, 72),
               (1, 130, 130, 2, 256), (1, 4096, 4096, 1, 64), (2, 18, 18, 2, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,d", CUDA_SHAPES)
def test_cuda_forward_kernel_matches_reference(b, tq, tk, h, d, dtype):
    _cuda()
    q, k, v, _ = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(b, tq, tk, h, d))
    before = flash_attention.launches
    by_design = dict(flash_attention.launches_by_design)
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    design = flash_fwd_design(dtype, d, d ** -0.5, (q, k, v))
    by_design[design] += 1
    assert flash_attention.launches_by_design == by_design
    want, want_lse = flash_attention_reference(q, k, v)
    atol = 2e-5 if dtype == torch.float32 else 1e-2
    assert out.dtype == dtype and out.shape == (b, tq, h, d)
    assert (out.float() - want.float()).abs().max().item() <= atol
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,tq,tk,h,d", CUDA_SHAPES)
def test_cuda_backward_kernel_matches_reference(b, tq, tk, h, d, dtype, rtol):
    _cuda()
    q, k, v, g = (torch.from_numpy(a).cuda().to(dtype)
                  for a in _inputs(b, tq, tk, h, d, seed=8))
    out, lse = flash_attention_fwd(q, k, v)
    before = flash_attention_bwd.launches
    by_design = dict(flash_attention_bwd.launches_by_design)
    got = flash_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    by_design[flash_bwd_design(dtype, d, d ** -0.5, (q, k, v, *got))] += 1
    assert flash_attention_bwd.launches_by_design == by_design
    want = flash_attention_bwd_reference(q, k, v, out, lse, g)
    for name, x, w in zip("qkv", got, want):
        scale = w.float().abs().max().item()
        err = (x.float() - w.float()).abs().max().item()
        assert x.dtype == dtype and x.shape == w.shape
        assert err <= rtol * scale, (name, err, scale)


# The TMA + wgmma kernels: every padded head dim (32 with 64-byte rows, 64,
# and 128 as two slabs; D = 8, 24 and 40 zero-filled by TMA), ragged T
# (136, 258: a last work item with one empty warpgroup), Tq != Tk both
# ways, and q, k and v as packed views.
# The last two run the forward on 128-key tiles (flash_fwd_key_tile): D = 32
# at T = 1024, and D = 64 with Tq = 256 against Tk = 512.
WGMMA_SHAPES = [(2, 136, 136, 2, 8), (2, 258, 258, 2, 24), (2, 136, 136, 4, 32),
                (1, 258, 258, 2, 40), (2, 258, 258, 16, 64), (2, 77, 300, 3, 32),
                (1, 300, 77, 2, 64), (1, 258, 258, 2, 96), (1, 136, 136, 2, 128),
                (1, 1024, 1024, 2, 32), (2, 256, 512, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,packed", [
    (*shape, packed) for shape in WGMMA_SHAPES
    for packed in ((False, True) if shape[1] == shape[2] else (False,))])
def test_cuda_wgmma_kernels_match_reference(b, tq, tk, h, d, packed):
    _cuda()
    q, k, v, g = (torch.from_numpy(a).cuda().bfloat16()
                  for a in _inputs(b, tq, tk, h, d, seed=11))
    grads = None
    if packed:
        qkv = torch.stack([q, k, v], dim=2)
        q, k, v = qkv.unbind(2)
        grads = torch.empty_like(qkv).unbind(2)
    fwd = dict(flash_attention.launches_by_design)
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash_fwd_design(torch.bfloat16, d, d ** -0.5) == "wgmma"
    fwd["wgmma"] += 1
    assert flash_attention.launches_by_design == fwd
    want, want_lse = flash_attention_reference(q, k, v)
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4

    design = flash_bwd_design(torch.bfloat16, d, d ** -0.5)
    assert design == "wgmma"
    bwd = dict(flash_attention_bwd.launches_by_design)
    got = [x.clone() for x in flash_attention_bwd(q, k, v, out, lse, g, grads=grads)]
    again = flash_attention_bwd(q, k, v, out, lse, g, grads=grads)
    torch.cuda.synchronize()
    bwd[design] += 2
    assert flash_attention_bwd.launches_by_design == bwd
    assert all(torch.equal(x, y) for x, y in zip(got, again)), "repeat not bit-equal"
    for name, x, w in zip("qkv", got, flash_attention_bwd_reference(q, k, v, out, lse, g)):
        scale = w.float().abs().max().item()
        err = (x.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(8, 256, 12, 64), (4, 1024, 6, 64)])
def test_cuda_wgmma_errors_within_sdpa_ratio(b, t, h, d):
    """The wgmma forward and backward pair take P and dS as one bf16 term,
    and each output's root mean square error against the f32 plain version
    on the same bf16 inputs (o; dq, dk and dv over max|grad|) is at most 1.5
    times SDPA's (and its backward's) on the same inputs
    (chip_smoke.py:attention_errors, SDPA_ERR_RATIO): at DiT-B/2's T = 256
    and ADM-64's T = 1024, q, k and v views of one packed projection,
    128-key tiles in the forward."""
    _cuda()
    import chip_smoke

    rng = np.random.default_rng(14)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, d)).astype(np.float32)).cuda()
    qkv = qkv.bfloat16()
    g = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32)).cuda().bfloat16()
    q, k, v = qkv.unbind(2)
    assert port_flash.flash_fwd_key_tile(t, t, port_flash._wgmma_dp(d)) == 128
    out, lse = flash_attention_fwd(q, k, v)
    grads = torch.empty_like(qkv)
    flash_attention_bwd(q, k, v, out, lse, g, grads=grads.unbind(2))
    kernel, sdpa, _ = chip_smoke.attention_errors(q, k, v, out, g, grads.unbind(2))
    assert set(kernel) == {"o", "dq", "dk", "dv"}
    for name in kernel:
        assert kernel[name]["rms"] <= chip_smoke.SDPA_ERR_RATIO * sdpa[name]["rms"], (
            name, kernel[name], sdpa[name])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_cuda_scale_not_positive_takes_the_mma_sync_kernels(scale):
    """A bf16 call with scale <= 0 goes, by the call, to the mma.sync
    forward and backward (the wgmma softmax takes its max on the raw
    scores), and matches the plain versions."""
    _cuda()
    q, k, v, g = (torch.from_numpy(a).cuda().bfloat16()
                  for a in _inputs(2, 136, 77, 2, 64, seed=12))
    fwd = dict(flash_attention.launches_by_design)
    bwd = dict(flash_attention_bwd.launches_by_design)
    out, lse = flash_attention_fwd(q, k, v, scale)
    got = flash_attention_bwd(q, k, v, out, lse, g, scale)
    torch.cuda.synchronize()
    fwd["mma_sync"] += 1
    bwd["mma_sync"] += 1
    assert flash_attention.launches_by_design == fwd
    assert flash_attention_bwd.launches_by_design == bwd
    want, want_lse = flash_attention_reference(q, k, v, scale)
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for name, x, w in zip("qkv", got, flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                                    scale)):
        err = (x.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(w.float().abs().max().item(), 1e-6), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_packed_reads_views_and_writes_one_gradient(dtype, rtol):
    _cuda()
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy((rng.standard_normal((4, 258, 3, 4, 64)) * 0.5)
                           .astype(np.float32)).cuda().to(dtype).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((4, 258, 4, 64)).astype(np.float32)).cuda()
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention_packed(qkv)
    (out.float() * g).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    x = qkv.detach()
    want_o, lse = flash_attention_reference(*x.unbind(2))
    want = torch.stack(flash_attention_bwd_reference(
        *x.unbind(2), want_o, lse, g.to(dtype)), dim=2)
    assert (out.float() - want_o.float()).abs().max().item() <= (
        2e-5 if dtype == torch.float32 else 1e-2)
    assert qkv.grad.shape == qkv.shape and qkv.grad.dtype == dtype
    err = (qkv.grad.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_cuda_expanded_k_and_v_take_the_mma_sync_kernels(d):
    """k and v expanded over the heads (a stride of 0) have no tensor map:
    the bf16 forward and backward go to the mma.sync kernels, counted there,
    and match the plain versions, the gradient through the expand
    included."""
    _cuda()
    q, k, v, g = _inputs(2, 136, 77, 4, d, seed=13)
    qt = torch.from_numpy(q).cuda().bfloat16().requires_grad_(True)
    k1, v1 = (torch.from_numpy(x[:, :, :1]).cuda().bfloat16().requires_grad_(True)
              for x in (k, v))
    ke, ve = (x.expand(2, 77, 4, d) for x in (k1, v1))
    g = torch.from_numpy(g).cuda().bfloat16()
    fwd = dict(flash_attention.launches_by_design)
    bwd = dict(flash_attention_bwd.launches_by_design)
    out = flash_attention(qt, ke, ve)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    fwd["mma_sync"] += 1
    bwd["mma_sync"] += 1
    assert flash_attention.launches_by_design == fwd
    assert flash_attention_bwd.launches_by_design == bwd
    want, lse = flash_attention_reference(qt.detach(), ke.detach(), ve.detach())
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    dq, dk, dv = flash_attention_bwd_reference(qt.detach(), ke.detach(), ve.detach(),
                                               want, lse, g)
    for got, w in ((qt.grad, dq.float()), (k1.grad, dk.float().sum(2, keepdim=True)),
                   (v1.grad, dv.float().sum(2, keepdim=True))):
        err = (got.float() - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), err


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    _cuda()
    q = torch.zeros(1, 16, 2, 264, device="cuda")
    with pytest.raises(ValueError, match="D <= 256"):
        flash_attention_fwd(q, q, q)
    x = torch.zeros(1, 16, 2, 9, device="cuda")[..., :8]  # rows 36 bytes apart
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(x, x, x)
    h = torch.zeros(1, 16, 2, 8, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(h, h, h)
