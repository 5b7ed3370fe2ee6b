"""The general attention pair's launch plans (vaw_torch/ops/flash_attention.py:
``_Plan``): what a call signature fixes (the checks, the design, the C
entry's stride array, the scratch) is worked out at its first call and
looked up at every later one; each call still checks its base pointers.

The plan builders read dtypes, devices, shapes and strides only, so they run
on CPU tensors here: over a grid of view layouts each plan's design and
stride array equal what the design rules and ``_map_strides`` /
``_strides`` give freshly, and a refused layout raises the same error at
every call. Signatures that differ in one stride, the dtype, the sign of
the scale or a patched ``TF32X3_MIN_TILES`` have different keys and plans.
The card's cases (marked ``cuda``; skipped without a card) hold the
entries' outputs bit-equal with the plans cold and warm, after a base is
reused with another shape, and with the backward on autograd's worker
thread.
"""

from __future__ import annotations

import threading

import pytest
import torch

from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_reference,
    flash_bwd_design,
    flash_fwd_design,
)

B, T, H, D = 2, 64, 4, 64
LAYOUTS = ["contiguous", "packed", "heads_major", "expanded", "base_off_16",
           "stride_off_16", "d_not_unit"]
# What the wrapper's checks say of the layouts the kernels refuse.
REFUSED = {"base_off_16": "16-byte aligned rows", "stride_off_16": "16-byte aligned rows",
           "d_not_unit": "unit stride over D"}


def _tensor(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to(dtype)


def _views(layout: str, dtype: torch.dtype, b=B, t=T, h=H, d=D):
    """q, k and v [B, T, H, D] in one layout, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    if layout == "contiguous":
        return tuple(_tensor(gen, (b, t, h, d), dtype) for _ in range(3))
    if layout == "packed":
        return _tensor(gen, (b, t, 3, h, d), dtype).unbind(2)
    if layout == "heads_major":
        return tuple(_tensor(gen, (b, h, t, d), dtype).transpose(1, 2) for _ in range(3))
    if layout == "expanded":  # k and v shared by the heads: stride 0
        q = _tensor(gen, (b, t, h, d), dtype)
        return (q, *(_tensor(gen, (b, t, 1, d), dtype).expand(b, t, h, d) for _ in range(2)))
    if layout == "base_off_16":  # every base 8 bytes past a 16-byte boundary
        n, off = b * t * h * d, 8 // torch.empty((), dtype=dtype).element_size()
        return tuple(_tensor(gen, (n + off,), dtype)[off:].view(b, t, h, d)
                     for _ in range(3))
    if layout == "stride_off_16":  # rows of D + 2 values: the head stride off 16 bytes
        return tuple(_tensor(gen, (b, t, h, d + 2), dtype)[..., :d] for _ in range(3))
    if layout == "d_not_unit":
        return tuple(_tensor(gen, (b, t, d, h), dtype).transpose(2, 3) for _ in range(3))
    raise ValueError(layout)


def _bwd_tensors(layout: str, dtype: torch.dtype):
    """q, k, v, out, lse, dout and the three gradients of one layout: a
    packed row's gradient for the packed layout, contiguous ones otherwise
    (as the wrapper allocates them)."""
    q, k, v = _views(layout, dtype)
    out = torch.zeros((B, T, H, D), dtype=dtype)
    dout = torch.zeros((B, T, H, D), dtype=dtype)
    lse = torch.zeros((B * H, T), dtype=torch.float32)
    if layout == "packed":
        grads = torch.empty((B, T, 3, H, D), dtype=dtype).unbind(2)
    else:
        grads = port_flash._contiguous_grads(q, k, v)
    return q, k, v, out, lse, dout, grads


def _raised(fn):
    with pytest.raises((ValueError, TypeError)) as info:
        fn()
    return type(info.value), str(info.value)


def _fresh_strides(design: str, views) -> list:
    mapped = design in ("wgmma", "tf32x3")
    return list((port_flash._map_strides if mapped else port_flash._strides)(*views))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_plan_matches_the_fresh_rules(layout, dtype, monkeypatch):
    """The plan's design and stride array are flash_fwd_design's and
    _map_strides' (or _strides') on the same views; a refused layout raises
    the same error at a first and a repeated call. Both f32 designs are
    reached: the crossover at 0 and at its value."""
    q, k, v = _views(layout, dtype)
    for tiles in (0, port_flash.TF32X3_MIN_TILES, 1 << 62):
        monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", tiles)
        for scale in (0.125, -0.125):
            build = lambda: port_flash._general_fwd_plan(q, k, v, scale)  # noqa: E731
            if layout in REFUSED:
                first = _raised(build)
                assert REFUSED[layout] in first[1]
                assert _raised(build) == first
                continue
            plan = build()
            assert plan.design == flash_fwd_design(dtype, D, scale, (q, k, v))
            assert list(plan.strides) == _fresh_strides(plan.design, (q, k, v))
            assert plan.dims == (B, T, T, H, D)
            assert plan.tail == (() if plan.design in ("wgmma", "tf32x3")
                                 else (int(dtype == torch.bfloat16),))
            assert plan.kernel is None and plan.scratch == 0
    if layout == "expanded":
        assert plan.design == ("fma" if dtype == torch.float32 else "mma_sync")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_plan_matches_the_fresh_rules(layout, dtype, monkeypatch):
    """As the forward, on the six views of a backward (q, k, v and the
    gradients) with out, lse and dout."""
    q, k, v, out, lse, dout, grads = _bwd_tensors(layout, dtype)
    views = (q, k, v, *grads)
    for tiles in (0, 1 << 62):
        monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", tiles)
        for scale in (0.125, -0.125):
            build = lambda: port_flash._general_bwd_plan(  # noqa: E731
                q, k, v, out, lse, dout, scale, grads)
            if layout in REFUSED:
                first = _raised(build)
                assert REFUSED[layout] in first[1]
                assert _raised(build) == first
                continue
            plan = build()
            assert plan.design == flash_bwd_design(dtype, D, scale, views)
            assert list(plan.strides) == _fresh_strides(plan.design, views)
            assert plan.dims == (B, T, T, H, D)


def test_a_refused_tensor_raises_at_every_call():
    """out, lse and dout that the kernels refuse (a wrong shape, dtype or
    layout) raise from the plan builder at every call, with the wrapper's
    messages."""
    q, k, v, out, lse, dout, grads = _bwd_tensors("packed", torch.bfloat16)
    for bad, match in ((dict(out=out[:1]), "out must be"),
                       (dict(lse=lse.to(torch.bfloat16)), "lse must be"),
                       (dict(dout=dout.transpose(1, 2).contiguous().transpose(1, 2)),
                        "contiguous, 16-byte aligned dout")):
        args = dict(q=q, k=k, v=v, out=out, lse=lse, dout=dout, scale=0.125, grads=grads)
        args.update(bad)
        build = lambda: port_flash._general_bwd_plan(**args)  # noqa: E731
        first = _raised(build)
        assert match in first[1]
        assert _raised(build) == first


def test_every_base_is_checked_at_every_call():
    """A signature's plan says nothing of the bases: the per-call check
    raises, with _check_view's message, for a view whose base is off 16
    bytes, and with the dense tensors' message for out, lse or dout."""
    q, k, v = _views("base_off_16", torch.bfloat16)
    with pytest.raises(ValueError) as fresh:
        port_flash._check_view("k", k, torch.bfloat16, k.device)
    with pytest.raises(ValueError) as per_call:
        port_flash._check_bases((("q", _views("contiguous", torch.bfloat16)[0]), ("k", k)))
    assert str(per_call.value) == str(fresh.value)
    lse = torch.zeros(2 * B * H * T + 2)[2:].view(B * H, 2 * T)
    with pytest.raises(ValueError, match="contiguous, 16-byte aligned lse"):
        port_flash._check_bases((), (("lse", lse),))


def test_signatures_that_differ_get_different_plans(monkeypatch):
    """Keys differ, and so do the plans, for one stride (packed against
    contiguous views), the dtype, the sign of the scale and a patched
    TF32X3_MIN_TILES; fresh tensors of one signature share a key."""
    q, k, v = _views("contiguous", torch.float32)
    key = port_flash._fwd_key(q, k, v, 0.125)
    assert port_flash._fwd_key(*_views("contiguous", torch.float32), 0.125) == key
    assert port_flash._fwd_key(q, k, v, None) == key
    plan = port_flash._general_fwd_plan(q, k, v, 0.125)

    packed = _views("packed", torch.float32)
    assert port_flash._fwd_key(*packed, 0.125) != key
    assert list(port_flash._general_fwd_plan(*packed, 0.125).strides) != list(plan.strides)

    bf16 = tuple(x.to(torch.bfloat16) for x in (q, k, v))
    assert port_flash._fwd_key(*bf16, 0.125) != key
    assert port_flash._general_fwd_plan(*bf16, 0.125).design == "wgmma" != plan.design

    assert port_flash._fwd_key(q, k, v, -0.125) != key
    assert port_flash._general_fwd_plan(q, k, v, -0.125).design == "fma"

    designs = {}
    for tiles in (0, 1 << 62):
        monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", tiles)
        designs[port_flash._fwd_key(q, k, v, 0.125)] = port_flash._general_fwd_plan(
            q, k, v, 0.125).design
    assert sorted(designs.values()) == ["fma", "tf32x3"]

    q, k, v, out, lse, dout, grads = _bwd_tensors("contiguous", torch.float32)
    keys = {port_flash._bwd_key(q, k, v, out, lse, dout, s, g)
            for s in (0.125, -0.125) for g in (None, grads)}
    assert len(keys) == 4


def test_plans_are_bounded_and_refusals_never_stored():
    """The table keeps its newest _PLAN_SLOTS plans; a CPU call or a
    refused one stores nothing."""
    before = dict(port_flash._plans)
    try:
        port_flash._plans.clear()
        q, k, v = _views("contiguous", torch.float32)
        flash_attention_fwd(q, k, v)                     # CPU: the plain version
        assert not port_flash._plans
        plan = port_flash._general_fwd_plan(q, k, v, 0.125)
        for i in range(port_flash._PLAN_SLOTS + 3):
            port_flash._remember(("test", i), plan)
        assert len(port_flash._plans) == port_flash._PLAN_SLOTS
        assert ("test", 2) not in port_flash._plans and ("test", 3) in port_flash._plans
    finally:
        port_flash._plans.clear()
        port_flash._plans.update(before)


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_inputs(dtype, b, t, h, d, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(dtype)
    dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    return qkv, dout


def _both_directions(qkv, dout):
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention_fwd(q, k, v)
    grad = torch.empty_like(qkv)
    flash_attention_bwd(q, k, v, o, lse, dout, grads=grad.unbind(2))
    torch.cuda.synchronize()
    return o, lse, grad


CARD_CASES = [(torch.bfloat16, 2, 64, 4, 96), (torch.bfloat16, 2, 258, 4, 128),
              (torch.float32, 4, 64, 12, 64), (torch.float32, 4, 65, 12, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,h,d", CARD_CASES)
def test_cold_and_warm_calls_are_bit_equal(dtype, b, t, h, d, monkeypatch):
    """A call that builds its plans and the same call again (its plans
    looked up) give bit-equal o, lse and gradients, within the plain
    version's tolerance; the second stores no plan. In f32 both designs."""
    _cuda()
    qkv, dout = _card_inputs(dtype, b, t, h, d)
    q, k, v = qkv.unbind(2)
    ro, _ = flash_attention_reference(q, k, v)
    for tiles in ((1, 1 << 62) if dtype == torch.float32 else (1,)):
        monkeypatch.setattr(port_flash, "TF32X3_MIN_TILES", tiles)
        port_flash._plans.clear()
        cold = _both_directions(qkv, dout)
        plans = dict(port_flash._plans)
        warm = _both_directions(qkv, dout)
        assert port_flash._plans == plans and len(plans) == 2
        assert {p.design for p in plans.values()} == {
            "wgmma" if dtype == torch.bfloat16 else "tf32x3" if tiles == 1 else "fma"}
        for x, y in zip(cold, warm):
            assert torch.equal(x, y)
        assert (cold[0].float() - ro.float()).abs().max().item() <= (
            2e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_a_base_reused_with_another_shape():
    """One buffer read as two shapes in turn (the same base, other dims and
    strides, as when the allocator hands an address back): each call is the
    plain version's within tolerance and bit-equal to the same call on a
    copy at another address."""
    _cuda()
    buf = torch.randn(2 * 128 * 3 * 4 * 64, device="cuda").to(torch.bfloat16)
    for shape in ((2, 128, 3, 4, 64), (2, 64, 3, 8, 64), (2, 128, 3, 4, 64)):
        qkv = buf.view(shape)
        dout = torch.randn(shape[:2] + shape[3:], device="cuda").to(torch.bfloat16)
        here = _both_directions(qkv, dout)
        there = _both_directions(qkv.clone(), dout)
        for x, y in zip(here, there):
            assert torch.equal(x, y)
        ro, _ = flash_attention_reference(*qkv.unbind(2))
        assert (here[0].float() - ro.float()).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_backward_on_autograds_worker_thread():
    """A forward on this thread and its backward on autograd's worker (a
    thread that may make no CUDA call before it) give the gradient that a
    backward called on this thread gives, bit for bit."""
    _cuda()
    qkv, dout = _card_inputs(torch.bfloat16, 2, 64, 4, 96, seed=3)
    q, k, v = (x.detach().clone().requires_grad_(True) for x in qkv.unbind(2))
    seen = set()
    real = port_flash._check_bases

    def spy(views, dense=()):
        if dense:  # the backward's out, dout and lse
            seen.add(threading.get_ident())
        return real(views, dense)

    port_flash._check_bases = spy
    try:
        flash_attention(q, k, v).backward(dout)
    finally:
        port_flash._check_bases = real
    torch.cuda.synchronize()
    assert seen and threading.get_ident() not in seen
    o, lse = flash_attention_fwd(*qkv.unbind(2))
    want = flash_attention_bwd(*qkv.unbind(2), o, lse, dout)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


@pytest.mark.cuda
def test_a_misaligned_base_raises_on_a_planned_signature():
    """A signature already planned, called with a base off 16 bytes (a
    view one element into its buffer), raises at every call."""
    _cuda()
    buf = torch.randn(2 * 64 * 4 * 64 + 8, device="cuda").to(torch.bfloat16)
    q = buf[:-8].view(2, 64, 4, 64)
    flash_attention_fwd(q, q, q)
    off = buf[4:-4].view(2, 64, 4, 64)  # 8 bytes in
    for _ in range(2):
        with pytest.raises(ValueError, match="16-byte aligned rows; q has base"):
            flash_attention_fwd(off, q, q)
