"""Parity of the port's 3x3 conv (vaw_torch/ops/conv2d.py) with the JAX
package's (vaw_tpu/ops/conv2d.py), and of its routing gate.

On the CPU the port's ``conv3x3`` runs its plain versions; JAX's runs its
Pallas kernels in interpret mode, by patching ``pl.pallas_call`` with
``interpret=True`` as tests/test_ops.py does (nothing in vaw_tpu changes).
Inputs are numpy arrays from a seed, handed to both.

Tolerances: f32 at tests/test_ops.py's (atol 2e-5, rtol 1e-5 for y and dx;
2e-4 and 1e-4 for dw), both sides summing in f32 in different orders. bf16:
both sides multiply bf16 values exactly into f32 sums and round once, so
they differ by the summation order and at most one bf16 rounding step:
within 1e-2 of the largest magnitude of each result (bf16 keeps 8 bits).

The gate: the port's ``conv3x3_supported`` against JAX's over every
stride-1 3x3 conv call of an ADM-64 forward in bf16 and in f32 compute (71
calls each, the f32 head among them), recorded on the meta device, and a
few edge shapes. Then the port's own choice among its three forward kernels
(``conv3x3_design``: wgmma, mma.sync, FMA) for each admitted conv and its
dgrad, and among its three wgrad kernels (``conv3x3_wgrad_design``) for each
admitted wgrad; the forward wgmma kernel's pixel box
(``conv3x3_wgmma_tiling``), and the wgrad wgmma kernel's tiling and split
of the pixels (``conv3x3_wgrad_plan``).

Tests marked ``cuda`` hold each kernel against its plain version on the
card and skip here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vaw_tpu.ops.conv2d as jax_conv
from vaw_torch.models import unet as port_unet
from vaw_torch.ops import conv2d as port_conv

SHAPES = [(2, 16, 8, 24, 16), (2, 8, 8, 3, 16), (2, 8, 8, 16, 3)]
TOL = {"f32": dict(y=(2e-5, 1e-5), dx=(2e-5, 1e-5), dw=(2e-4, 1e-4))}
BF16_REL = 1e-2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                             interpret=True))


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    return x, wt, g


def _jax(x, wt, g, dtype):
    jx, jw, jg = (jnp.asarray(a, dtype) for a in (x, wt, g))
    y = jax_conv.conv3x3(jx, jw)
    dx, dw = jax.grad(lambda a, b: jnp.sum((jax_conv.conv3x3(a, b) * jg).astype(
        jnp.float32)), argnums=(0, 1))(jx, jw)
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dx, dw)]


def _port(x, wt, g, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(wt).to(dtype).requires_grad_(True)
    y = port_conv.conv3x3(tx, tw)
    (y * torch.from_numpy(g).to(dtype)).float().sum().backward()
    assert y.dtype == tx.grad.dtype == tw.grad.dtype == dtype
    return [a.detach().float().numpy() for a in (y, tx.grad, tw.grad)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
def test_conv3x3_matches_jax(n, h, w, cin, cout, dtype, interpret):
    x, wt, g = _inputs(n, h, w, cin, cout)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = _jax(x, wt, g, jdt)
    got = _port(x, wt, g, tdt)
    assert [a.shape for a in got] == [(n, h, w, cout), (n, h, w, cin), (3, 3, cin, cout)]
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        if dtype == "f32":
            atol, rtol = TOL["f32"][name]
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)
        else:
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= BF16_REL, (name, err)


def test_reference_matches_torch_conv2d():
    """The plain versions against torch's own conv and its filter gradient
    (an extra check; the port never calls them on the path)."""
    x, wt, g = (torch.from_numpy(a).double() for a in _inputs(2, 8, 16, 24, 16, seed=3))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(port_conv.conv3x3_reference(x.float(), wt.float()),
                               want.float(), atol=2e-5, rtol=1e-5)
    dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (16, 24, 3, 3),
                                     g.permute(0, 3, 1, 2), padding=1)
    torch.testing.assert_close(port_conv.conv3x3_wgrad_reference(x.float(), g.float()),
                               dw.permute(2, 3, 1, 0).float(), atol=2e-4, rtol=1e-4)


def test_dx_is_skipped_for_an_input_without_grad():
    x, wt, g = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 3, 16, seed=4))
    wt.requires_grad_(True)
    (port_conv.conv3x3(x, wt) * g).sum().backward()
    assert x.grad is None and wt.grad.shape == (3, 3, 3, 16)


def _adm64_gate_calls(compute_dtype):
    """Every conv3x3_supported call of one ADM-64 forward under
    VAW_PALLAS_CONV=1, recorded on the meta device (shapes only: the convs
    and the attention are replaced by empty results)."""
    calls = []
    real = port_unet.conv3x3_supported

    def record(shape, cout, tile_h=8, *, itemsize):
        calls.append((tuple(shape), cout, itemsize))
        return real(shape, cout, tile_h, itemsize=itemsize)

    def conv(x, w):
        return x.new_empty(x.shape[:3] + (w.shape[-1],))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VAW_PALLAS_CONV", "1")
        mp.setattr(port_unet, "conv3x3_supported", record)
        mp.setattr(port_unet, "conv3x3", conv)
        mp.setattr(port_unet, "multi_head_attention_packed", lambda qkv: qkv[:, :, 0])
        with torch.device("meta"):
            model = port_unet.ADM_64(num_classes=1000, drop_label_prob=0.1,
                                     compute_dtype=compute_dtype)
            model(torch.empty(2, 64, 64, 3), torch.empty(2), torch.zeros(2, dtype=torch.long))
    return calls


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_adm64_routes_the_convs_the_jax_gate_admits(dtype):
    """30 of the 71 convs in bf16 compute, 26 in f32: the gate's budget
    grows with the dtype's size and then leaves the 64 px 384 -> 192 convs
    and the 16 px 384 -> 576 one to cuDNN."""
    calls = _adm64_gate_calls(torch.bfloat16 if dtype == "bf16" else None)
    assert len(calls) == 71
    admitted = [c for c in calls if port_conv.conv3x3_supported(c[0], c[1], itemsize=c[2])]
    assert len(admitted) == {"bf16": 30, "f32": 26}[dtype]
    itemsize = {"bf16": 2, "f32": 4}[dtype]
    assert ((2, 64, 64, 192), 3, 4) in admitted  # the f32 head
    assert ((2, 64, 64, 3), 192, itemsize) in admitted  # the stem, on the image
    assert not any(shape[1] == 8 for shape, _, _ in admitted)  # nothing at 8x8
    edges = [((2, 12, 16, 64), 64, 2), ((2, 16, 12, 64), 64, 2), ((1, 4, 8, 32), 32, 2),
             ((1, 8, 8, 1536), 1536, 2), ((1, 8, 8, 1152), 192, 4),
             ((1, 8, 8, 1152), 192, 2), ((4, 32, 32, 576), 576, 2)]
    for shape, cout, itemsize in calls + edges:
        assert port_conv.conv3x3_supported(shape, cout, itemsize=itemsize) == \
            jax_conv.conv3x3_supported(shape, cout, itemsize=itemsize), (shape, cout)


# One ADM-64 forward's admitted convs and one backward's dgrads, by kernel.
ADM64_DESIGNS = {("bf16", "fwd"): {"wgmma": 28, "mma_sync": 1, "fma": 1},
                 ("bf16", "dgrad"): {"wgmma": 28, "fma": 1},
                 ("f32", "fwd"): {"fma": 26},
                 ("f32", "dgrad"): {"fma": 25}}


@pytest.mark.parametrize("dtype,direction", list(ADM64_DESIGNS))
def test_adm64_convs_take_the_kernel_their_shape_selects(dtype, direction):
    """Every bf16 conv with Cin and Cout multiples of 64 goes to wgmma, the
    3-channel stem to mma.sync and the f32 head (and everything in f32) to
    the FMA kernel; the dgrad is the forward with Cin and Cout swapped, and
    the image at the stem has none."""
    calls = _adm64_gate_calls(torch.bfloat16 if dtype == "bf16" else None)
    counts = {}
    for shape, cout, itemsize in calls:
        if not port_conv.conv3x3_supported(shape, cout, itemsize=itemsize):
            continue
        tdt = torch.bfloat16 if itemsize == 2 else torch.float32
        cin = shape[-1]
        if direction == "dgrad":
            if cin == 3:
                continue
            shape, cin, cout = shape[:-1] + (cout,), cout, cin
        design = port_conv.conv3x3_design(shape, cout, tdt)
        if tdt == torch.float32:
            assert design == "fma", (shape, cout)
        elif cin % 64 == 0 and cout % 64 == 0:
            assert design == "wgmma", (shape, cout)
        else:
            assert design == "mma_sync" and 3 in (cin, cout), (shape, cout)
        counts[design] = counts.get(design, 0) + 1
    assert counts == ADM64_DESIGNS[dtype, direction]


@pytest.mark.parametrize("shape,cout,dtype,design", [
    ((2, 64, 64, 3), 192, torch.bfloat16, "mma_sync"),     # the stem
    ((2, 64, 64, 192), 3, torch.float32, "fma"),           # the f32 head
    ((2, 64, 64, 192), 3, torch.bfloat16, "mma_sync"),
    ((2, 64, 64, 192), 192, torch.bfloat16, "wgmma"),
    ((2, 16, 16, 384), 576, torch.bfloat16, "wgmma"),
    ((3, 12, 20, 64), 128, torch.bfloat16, "wgmma"),
    ((2, 8, 8, 96), 64, torch.bfloat16, "mma_sync"),       # Cin % 64 != 0
    ((2, 8, 8, 64), 96, torch.bfloat16, "mma_sync"),       # Cout % 64 != 0
    ((2, 16, 8, 24), 16, torch.bfloat16, "mma_sync"),
    ((2, 64, 64, 192), 192, torch.float32, "fma"),
])
def test_design_is_chosen_by_shape(shape, cout, dtype, design):
    assert port_conv.conv3x3_design(shape, cout, dtype) == design


@pytest.mark.parametrize("h,w,cout,tiling", [
    (64, 64, 192, (1, 2, 64, 192)), (32, 32, 384, (1, 4, 32, 192)),
    (16, 16, 576, (1, 8, 16, 192)), (8, 8, 768, (2, 8, 8, 192)),
    (12, 20, 128, (1, 4, 32, 128)), (64, 64, 64, (1, 2, 64, 64)),
    (4, 256, 320, (1, 1, 128, 64)), (3, 5, 64, (4, 4, 8, 64))])
def test_wgmma_tiling(h, w, cout, tiling):
    got = port_conv.conv3x3_wgmma_tiling(h, w, cout)
    assert got == tiling
    bni, bh, bw, bn = got
    assert bni * bh * bw == 128 and max(bni, bh, bw) <= 128 and cout % bn == 0


def test_wgmma_box_tiles_every_admitted_image_exactly():
    """The box (images x rows x columns = 128 pixels) divides the image of
    every ADM-64 conv and dgrad that goes to wgmma: no tile is partial."""
    seen = set()
    for shape, cout, itemsize in _adm64_gate_calls(torch.bfloat16):
        if not port_conv.conv3x3_supported(shape, cout, itemsize=itemsize):
            continue
        n, h, w, cin = shape
        for ci, co in ((cin, cout), (cout, cin)):
            dt = torch.bfloat16 if itemsize == 2 else torch.float32
            if port_conv.conv3x3_design((n, h, w, ci), co, dt) != "wgmma":
                continue
            bni, bh, bw, bn = port_conv.conv3x3_wgmma_tiling(h, w, co)
            assert bni * bh * bw == 128 and h % bh == 0 and w % bw == 0 and bni == 1
            assert co % bn == 0 and bn == 192
            seen.add((h, w))
    assert seen == {(64, 64), (32, 32), (16, 16)}


# One ADM-64 backward's wgrads (one for every admitted conv, the stem's
# included), by kernel.
ADM64_WGRAD_DESIGNS = {"bf16": {"wgmma": 28, "mma_sync": 1, "fma": 1}, "f32": {"fma": 26}}


@pytest.mark.parametrize("dtype", list(ADM64_WGRAD_DESIGNS))
def test_adm64_wgrads_take_the_kernel_their_shape_selects(dtype):
    """Every bf16 wgrad with Cin and Cout multiples of 64 goes to wgmma, the
    stem's (3 -> 192) to mma.sync and the f32 head's (and everything in f32)
    to the FMA kernel."""
    counts = {}
    for shape, cout, itemsize in _adm64_gate_calls(
            torch.bfloat16 if dtype == "bf16" else None):
        if not port_conv.conv3x3_supported(shape, cout, itemsize=itemsize):
            continue
        tdt = torch.bfloat16 if itemsize == 2 else torch.float32
        design = port_conv.conv3x3_wgrad_design(shape, cout, tdt)
        if tdt == torch.float32:
            assert design == "fma", (shape, cout)
        elif shape[-1] % 64 == 0 and cout % 64 == 0:
            assert design == "wgmma", (shape, cout)
        else:
            assert design == "mma_sync" and shape[-1] == 3, (shape, cout)
        counts[design] = counts.get(design, 0) + 1
    assert counts == ADM64_WGRAD_DESIGNS[dtype]


@pytest.mark.parametrize("shape,cout,dtype,design", [
    ((64, 64, 64, 3), 192, torch.bfloat16, "mma_sync"),     # the stem
    ((64, 64, 64, 192), 3, torch.float32, "fma"),           # the f32 head
    ((64, 64, 64, 192), 192, torch.bfloat16, "wgmma"),
    ((64, 64, 64, 384), 192, torch.bfloat16, "wgmma"),
    ((64, 32, 32, 384), 384, torch.bfloat16, "wgmma"),
    ((64, 16, 16, 384), 576, torch.bfloat16, "wgmma"),
    ((3, 12, 20, 64), 128, torch.bfloat16, "wgmma"),
    ((2, 8, 8, 96), 64, torch.bfloat16, "mma_sync"),        # Cin % 64 != 0
    ((2, 8, 8, 64), 96, torch.bfloat16, "mma_sync"),        # Cout % 64 != 0
    ((64, 64, 64, 192), 192, torch.float32, "fma"),
])
def test_wgrad_design_is_chosen_by_shape(shape, cout, dtype, design):
    assert port_conv.conv3x3_wgrad_design(shape, cout, dtype) == design


def _wgrad_wgmma_shapes():
    """(N, H, W, Cin, Cout) of every bf16 ADM-64 wgrad that goes to wgmma,
    at the training batch 64, and edge shapes: a box past the image
    (3, 12, 20), 8 px images, Cout = 64 and 128."""
    seen = []
    for shape, cout, itemsize in _adm64_gate_calls(torch.bfloat16):
        if port_conv.conv3x3_supported(shape, cout, itemsize=itemsize) and \
                port_conv.conv3x3_wgrad_design(shape, cout, torch.bfloat16) == "wgmma":
            key = (64, *shape[1:], cout)
            if key not in seen:
                seen.append(key)
    return seen + [(3, 12, 20, 64, 128), (5, 8, 8, 128, 64), (1, 3, 5, 64, 192)]


@pytest.mark.parametrize("n,h,w,cin,cout", _wgrad_wgmma_shapes())
def test_wgrad_plan_covers_every_pixel_once(n, h, w, cin, cout):
    """The plan's boxes tile every image, each pixel in exactly one box of
    exactly one split, no split empty; its 64-row slabs never straddle a
    tap; and the blocks (tiles x splits) fill at most one wave of 132
    SMs unless the tiles alone exceed it."""
    bni, bh, bw, bn, splits, per = port_conv.conv3x3_wgrad_plan(n, h, w, cin, cout)
    assert bni * bh * bw == 64 and cout % bn == 0 and bn in (64, 128, 192)
    boxes_w, boxes_h = -(-w // bw), -(-h // bh)
    boxes = -(-n // bni) * boxes_h * boxes_w
    seen = np.zeros((n, h, w), dtype=np.int64)
    for split in range(splits):
        run = range(split * per, min((split + 1) * per, boxes))
        assert len(run) > 0, split
        for box in run:
            w0 = (box % boxes_w) * bw
            h0 = (box // boxes_w) % boxes_h * bh
            n0 = box // (boxes_w * boxes_h) * bni
            seen[n0:n0 + bni, h0:h0 + bh, w0:w0 + bw] += 1
    assert (seen == 1).all()
    assert splits * per >= boxes > (splits - 1) * per
    rows = np.arange(9 * cin)
    taps = (rows // cin).reshape(-1, 64)  # one row a 64-row slab
    assert (taps == taps[:, :1]).all()
    assert len(taps) % 3 == 0  # whole tiles of three slabs
    tiles = 3 * (cin // 64) * (cout // bn)
    assert tiles * splits <= max(port_conv.H100_SMS, tiles)


def test_wgrad_plan_at_the_timed_shape():
    """ADM-64's 64 px 192 -> 192 wgrad at batch 64: one 64-pixel row a box,
    9 tiles of 192 x 192, 14 splits of 293 boxes: 126 blocks."""
    assert port_conv.conv3x3_wgrad_plan(64, 64, 64, 192, 192) == (1, 1, 64, 192, 14, 293)


def test_cpu_wgrad_counts_no_kernel():
    before = (port_conv.conv3x3_wgrad_pallas.launches,
              dict(port_conv.conv3x3_wgrad_pallas.launches_by_design))
    x, _, g = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 64, 64, seed=7))
    port_conv.conv3x3_wgrad_pallas(x.bfloat16(), g.bfloat16())
    assert (port_conv.conv3x3_wgrad_pallas.launches,
            port_conv.conv3x3_wgrad_pallas.launches_by_design) == before


def test_cpu_call_counts_no_kernel():
    before = (port_conv.conv3x3_pallas.launches,
              dict(port_conv.conv3x3_pallas.launches_by_design))
    x, wt, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 64, 64, seed=7))
    port_conv.conv3x3_pallas(x.bfloat16(), wt)
    assert (port_conv.conv3x3_pallas.launches,
            port_conv.conv3x3_pallas.launches_by_design) == before


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match=r"\[3, 3, 8, Cout\]"):
        port_conv.conv3x3_pallas(torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match="N, H, W, C"):
        port_conv.conv3x3_pallas(torch.zeros(8, 8, 8), torch.zeros(3, 3, 8, 8))
    with pytest.raises(ValueError, match=r"g must be \[1, 8, 8, Cout\]"):
        port_conv.conv3x3_wgrad_pallas(torch.zeros(1, 8, 8, 8), torch.zeros(1, 8, 4, 8))


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


# The ADM-64 shapes at a small batch, the shapes above, ragged pixel counts
# and channels that are not multiples of 8.
CUDA_SHAPES = [(2, 64, 64, 192, 192), (2, 32, 32, 384, 384), (2, 16, 16, 384, 576),
               (2, 64, 64, 3, 192), (2, 64, 64, 192, 3), (2, 16, 8, 24, 16),
               (3, 5, 7, 16, 24), (1, 9, 3, 12, 20), (2, 8, 8, 3, 5),
               (3, 8, 8, 128, 64), (3, 12, 20, 64, 128)]
CUDA_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", CUDA_SHAPES)
def test_cuda_kernels_match_reference(n, h, w, cin, cout, dtype):
    _cuda()
    x, wt, g = (torch.from_numpy(a).cuda().to(dtype) for a in
                _inputs(n, h, w, cin, cout, seed=5))
    w_rot = wt.flip(0, 1).transpose(2, 3)
    before = port_conv.conv3x3_pallas.launches, port_conv.conv3x3_wgrad_pallas.launches
    designs = dict(port_conv.conv3x3_pallas.launches_by_design)
    wgrad_designs = dict(port_conv.conv3x3_wgrad_pallas.launches_by_design)
    got = [port_conv.conv3x3_pallas(x, wt), port_conv.conv3x3_pallas(g, w_rot),
           port_conv.conv3x3_wgrad_pallas(x, g)]
    torch.cuda.synchronize()
    assert (port_conv.conv3x3_pallas.launches - before[0],
            port_conv.conv3x3_wgrad_pallas.launches - before[1]) == (2, 1)
    for d in (port_conv.conv3x3_design(x.shape, cout, dtype),
              port_conv.conv3x3_design(g.shape, cin, dtype)):
        designs[d] += 1
    assert port_conv.conv3x3_pallas.launches_by_design == designs
    wgrad_designs[port_conv.conv3x3_wgrad_design(x.shape, cout, dtype)] += 1
    assert port_conv.conv3x3_wgrad_pallas.launches_by_design == wgrad_designs
    want = [port_conv.conv3x3_reference(x, wt), port_conv.conv3x3_reference(g, w_rot),
            port_conv.conv3x3_wgrad_reference(x, g)]
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= CUDA_RTOL[dtype] * scale, (name, err, scale)


@pytest.mark.cuda
def test_cuda_wgrad_is_deterministic_and_autograd_launches_the_kernels():
    _cuda()
    x, wt, g = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in
                _inputs(4, 32, 32, 64, 64, seed=6))
    before = port_conv.conv3x3_wgrad_pallas.launches_by_design["wgmma"]
    first = port_conv.conv3x3_wgrad_pallas(x, g)
    assert torch.equal(first, port_conv.conv3x3_wgrad_pallas(x, g))
    assert port_conv.conv3x3_wgrad_pallas.launches_by_design["wgmma"] == before + 2
    x.requires_grad_(True)
    wt.requires_grad_(True)
    before = port_conv.conv3x3_pallas.launches, port_conv.conv3x3_wgrad_pallas.launches
    (port_conv.conv3x3(x, wt) * g).sum().backward()
    assert (port_conv.conv3x3_pallas.launches - before[0],
            port_conv.conv3x3_wgrad_pallas.launches - before[1]) == (2, 1)
    assert x.grad.dtype == wt.grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    _cuda()
    w = torch.zeros(3, 3, 8, 8, device="cuda")
    with pytest.raises(TypeError, match="bf16 or f32"):
        port_conv.conv3x3_pallas(torch.zeros(1, 8, 8, 8, device="cuda",
                                             dtype=torch.float16), w)
    with pytest.raises(ValueError, match="contiguous"):
        port_conv.conv3x3_pallas(torch.zeros(1, 8, 8, 8, device="cuda").transpose(1, 2), w)
    with pytest.raises(TypeError, match="expected"):
        port_conv.conv3x3_wgrad_pallas(torch.zeros(1, 8, 8, 8, device="cuda"),
                                       torch.zeros(1, 8, 8, 8, device="cuda",
                                                   dtype=torch.bfloat16))
