"""The port's profiling utilities (vaw_torch/utils/profiling.py) against the
JAX package's (vaw_tpu/utils/profiling.py): summarize_trace on a Chrome
trace against summarize_xplane on the same events written as an xplane;
busy time as the union of device intervals; compiled_flops of a matmul and
a convolution; the kernel wrappers' FLOP formulas (vaw_torch/ops/flops.py)
against FlopCounterMode's count of their plain versions; estimate_train_flops;
StepTimer under one patched clock; trace() on the CPU.

Tolerances: times are sums of the same microsecond durations: within 1e-9
ms. FLOP counts are integers: equal. XLA's cost model counts a padded
convolution's in-bounds taps only, FlopCounterMode every tap, so the conv
compared is unpadded (VALID).
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from vaw_torch.ops import flash_attention as fa
from vaw_torch.ops import flops
from vaw_torch.ops.conv2d import conv3x3, conv3x3_reference, conv3x3_wgrad_reference
from vaw_torch.ops.fused_act import fused_leaky_relu_reference
from vaw_torch.utils import profiling as port
from vaw_tpu.utils import profiling as ref

# (name, start us, duration us, device, stream). The two bf16 GEMMs overlap
# on streams 7 and 13 of card 0, the memcpy overlaps the first; card 1
# holds two of its own. The event that starts last on a card ends last.
EVENTS = [
    ("ampere_bf16_s16816gemm_bf16_128x128", 100.0, 40.0, 0, 7),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", 120.0, 50.0, 0, 13),
    ("Memcpy HtoD (Pinned -> Device)", 105.0, 10.0, 0, 20),
    ("void flash_fused_fwd_wgmma<64>(...)", 200.0, 12.5, 0, 7),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", 215.0, 3.25, 0, 7),
    ("void flash_fused_bwd_fma(...)", 220.0, 30.0, 0, 7),
    ("Memset (Device)", 251.0, 1.0, 0, 7),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", 50.0, 20.0, 1, 30),
    ("void flash_fwd_wgmma(...)", 60.0, 30.0, 1, 7),
]


def _chrome_trace(path, events=EVENTS):
    trace_events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1234, "tid": 1,
         "ts": 90.0, "dur": 400.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#0", "pid": 0,
         "tid": 7, "ts": 90.0, "dur": 400.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1234,
         "tid": 1, "ts": 95.0, "dur": 4.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7, "ts": 100.0},
    ]
    cats = {"Memcpy": "gpu_memcpy", "Memset": "gpu_memset"}
    for name, ts, dur, device, stream in events:
        trace_events.append({
            "ph": "X", "cat": cats.get(name.split()[0], "kernel"), "name": name,
            "pid": device, "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": device, "stream": stream}})
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": trace_events}))
    return str(path)


def _xplane(path, events=EVENTS):
    """The same events on one "XLA Ops" line a card, each with its
    hlo_category (the port's category of its name) and tf_op (its name)."""
    from tensorflow.tsl.profiler.protobuf import xplane_pb2

    xs = xplane_pb2.XSpace()
    for device in sorted({e[3] for e in events}):
        plane = xs.planes.add()
        plane.name = f"/device:TPU:{device}"
        plane.stat_metadata[1].id = 1
        plane.stat_metadata[1].name = "hlo_category"
        plane.stat_metadata[2].id = 2
        plane.stat_metadata[2].name = "tf_op"
        line = plane.lines.add()
        line.name = "XLA Ops"
        for mid, (name, ts, dur, dev, _) in enumerate(events, start=1):
            if dev != device:
                continue
            meta = plane.event_metadata[mid]
            meta.id, meta.name = mid, f"fusion.{mid}"
            for sid, value in ((1, port.kernel_category(name)), (2, name)):
                st = meta.stats.add()
                st.metadata_id, st.str_value = sid, value
            ev = line.events.add()
            ev.metadata_id = mid
            ev.offset_ps, ev.duration_ps = int(ts * 1e6), int(dur * 1e6)
    with open(path, "wb") as f:
        f.write(xs.SerializeToString())
    return str(path)


def test_summarize_trace_equals_summarize_xplane(tmp_path):
    pytest.importorskip("tensorflow")
    got = port.summarize_trace(_chrome_trace(tmp_path / "t.json"))
    want = ref.summarize_xplane(_xplane(tmp_path / "t.xplane.pb"))
    assert got["busy_ms"] == pytest.approx(want["busy_ms"], abs=1e-9)
    assert got["span_ms"] == pytest.approx(want["span_ms"], abs=1e-9)
    assert list(got["categories"]) == list(want["categories"])
    for cat, ms in want["categories"].items():
        assert got["categories"][cat] == pytest.approx(ms, abs=1e-9), cat
    assert [n for n, _ in got["ops"]] == [n for n, _ in want["ops"]]
    np.testing.assert_allclose([ms for _, ms in got["ops"]],
                               [ms for _, ms in want["ops"]], atol=1e-9)


def test_busy_is_the_union_and_categories_the_sum(tmp_path):
    got = port.summarize_trace(_chrome_trace(tmp_path / "t.json"))
    # Card 0: [100, 170] (two GEMMs and the memcpy overlap), [200, 212.5],
    # [215, 218.25], [220, 250], [251, 252]; card 1: [50, 70], [60, 90].
    assert got["busy_ms"] == pytest.approx((70 + 12.5 + 3.25 + 30 + 1 + 40) / 1e3)
    assert got["span_ms"] == pytest.approx(0.152)
    assert got["categories"]["matmul (cuBLAS)"] == pytest.approx(0.090)
    assert got["categories"]["copies and casts"] == pytest.approx(0.011)
    assert got["categories"]["collectives (NCCL)"] == pytest.approx(0.020)
    assert sum(got["categories"].values()) == pytest.approx(
        sum(e[2] for e in EVENTS) / 1e3)
    assert sum(got["categories"].values()) > got["busy_ms"]
    assert len(port.summarize_trace(str(tmp_path / "t.json"), top=3)["ops"]) == 3


def test_span_covers_an_event_that_ends_after_the_last_start(tmp_path):
    # JAX's span is the last-starting event's end less the first start; an
    # earlier, longer event can end later, and the port's span covers it.
    events = [("gemm_a", 0.0, 100.0, 0, 7), ("gemm_b", 10.0, 5.0, 0, 13)]
    got = port.summarize_trace(_chrome_trace(tmp_path / "t.json", events))
    assert got["busy_ms"] == pytest.approx(0.1) and got["span_ms"] == pytest.approx(0.1)


def test_a_trace_without_device_events_fails(tmp_path):
    path = _chrome_trace(tmp_path / "t.json", events=[])
    with pytest.raises(ValueError, match="no device event"):
        port.summarize_trace(path)


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with port.trace(str(tmp_path / "logs")) as prof:
        (a @ a).sum()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path / "logs"))
    assert any(e.get("name") == "aten::mm" for e in events)
    # The CPU traces no card: reading it fails, it does not pass empty.
    with pytest.raises(ValueError, match="no device event"):
        port.summarize_trace(prof.trace_path)
    events.append({"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
                   "ts": 10.0, "dur": 2.5, "args": {"device": 0, "stream": 7}})
    with open(prof.trace_path, "w") as f:
        json.dump({"traceEvents": events}, f)
    got = port.summarize_trace(prof.trace_path)
    assert got["busy_ms"] == pytest.approx(0.0025)
    assert got["categories"] == {"matmul (cuBLAS)": pytest.approx(0.0025)}


def test_compiled_flops_of_a_matmul_and_a_conv_equal_jax():
    mm = port.compiled_flops(lambda a, b: a @ b, torch.ones(64, 64), torch.ones(64, 64))
    assert mm == ref.compiled_flops(lambda a, b: a @ b, jnp.ones((64, 64)),
                                    jnp.ones((64, 64))) == 2 * 64 ** 3

    def conv_jax(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1), "VALID",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = ref.compiled_flops(conv_jax, jnp.ones((2, 16, 16, 8)), jnp.ones((3, 3, 8, 12)))
    got = port.compiled_flops(F.conv2d, torch.ones(2, 8, 16, 16), torch.ones(12, 8, 3, 3))
    assert got == want == 2 * 2 * 14 * 14 * 12 * 8 * 9


def test_compiled_flops_adds_the_kernels_records_and_fails_to_none():
    assert port.compiled_flops(lambda: flops.record(12345)) == 12345
    flops.record(7)  # outside a count: recorded nowhere
    assert port.compiled_flops(lambda: None) == 0
    assert port.compiled_flops(lambda: 1 / 0) is None


def _flop_count(fn, *args):
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    return mode.get_total_flops()


@pytest.mark.parametrize("b,t,h,d", [(2, 16, 3, 8), (1, 33, 2, 40)])
def test_attention_formulas_equal_the_plain_versions_count(b, t, h, d):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen)
    out, lse = fa.flash_attention_fused_reference(qkv, h)
    dout = torch.randn_like(out)
    fwd, bwd = flops.attention_fwd_flops(b, t, t, h, d), flops.attention_bwd_flops(b, t, t, h, d)
    assert _flop_count(fa.flash_attention_fused_reference, qkv, h) == fwd
    assert _flop_count(fa.flash_attention_fused_bwd_reference, qkv, out, lse, dout, h) == bwd
    # The general kernels, Tq != Tk.
    tk = t + 5
    q = torch.randn(b, t, h, d, generator=gen)
    k, v = (torch.randn(b, tk, h, d, generator=gen) for _ in range(2))
    o, lse = fa.flash_attention_reference(q, k, v)
    assert _flop_count(fa.flash_attention_reference, q, k, v) == \
        flops.attention_fwd_flops(b, t, tk, h, d)
    assert _flop_count(fa.flash_attention_bwd_reference, q, k, v, o, lse,
                       torch.randn_like(o)) == flops.attention_bwd_flops(b, t, tk, h, d)
    # The d-major p5 kernels on [B, 3, H, D, T].
    f5 = torch.randn(b, 3, h, d, t, generator=gen)
    o5, lse5 = fa.flash_attention_p5_reference(f5)
    assert _flop_count(fa.flash_attention_p5_reference, f5) == fwd
    assert _flop_count(fa.flash_attention_p5_bwd_reference, f5, o5, lse5,
                       torch.randn_like(o5)) == bwd
    # Through the differentiable entry, forward and backward.
    x = qkv.clone().requires_grad_()
    assert port.compiled_flops(
        lambda: fa.flash_attention_fused(x, h)[0].backward(dout)) == fwd + bwd


@pytest.mark.parametrize("n,hw,cin,cout", [(2, 6, 8, 4), (1, 5, 3, 16)])
def test_conv_and_act_formulas_equal_the_plain_versions_count(n, hw, cin, cout):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, hw, hw + 1, cin, generator=gen)
    w = torch.randn(3, 3, cin, cout, generator=gen)
    g = torch.randn(n, hw, hw + 1, cout, generator=gen)
    want = flops.conv3x3_flops(n, hw, hw + 1, cin, cout)
    assert _flop_count(conv3x3_reference, x, w) == want
    assert _flop_count(conv3x3_wgrad_reference, x, g) == want
    # Forward, dgrad (the forward on the rotated filter) and wgrad.
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    assert port.compiled_flops(lambda: conv3x3(xr, wr).backward(g)) == 3 * want
    # The bias-act is elementwise: FlopCounterMode counts nothing, and its
    # wrapper records nothing.
    assert _flop_count(fused_leaky_relu_reference, x, torch.randn(cin, generator=gen)) == 0


def test_estimate_train_flops_equals_jax():
    for n_params, tokens in ((130_000_000, 256), (1e6, 258)):
        assert port.estimate_train_flops(n_params, tokens) == \
            ref.estimate_train_flops(n_params, tokens)


def _clock(monkeypatch):
    ticks = iter(np.cumsum(np.random.RandomState(5).uniform(0.05, 0.2, 100)))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


@pytest.mark.parametrize("window", [1, 3])
def test_step_timer_equals_jax_under_one_clock(monkeypatch, window):
    monkeypatch.setattr(jax, "devices", lambda *a: [object()])
    results = []
    for timer, scalar in ((port.StepTimer(32, window), torch.tensor(1.5)),
                          (ref.StepTimer(32, window), jnp.asarray(1.5))):
        _clock(monkeypatch)
        results.append([timer.lap(scalar) for _ in range(8)] + [timer.last_rate])
    got, want = results
    assert sum(r is not None for r in got[:-1]) == 7 // window
    for a, b in zip(got, want):
        if isinstance(b, dict):
            assert set(a) == set(b) == {"imgs_per_sec", "imgs_per_sec_chip", "step_ms"}
            for key in b:
                assert a[key] == pytest.approx(b[key], rel=1e-12), key
            assert a["imgs_per_sec_chip"] == a["imgs_per_sec"]
        else:
            assert a == pytest.approx(b, rel=1e-12)
