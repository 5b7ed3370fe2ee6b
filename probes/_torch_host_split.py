"""Where the host time of a general attention call goes, with the
``vaw_torch`` of the checkout named by --tree (run it on two checkouts in
one call on the card to compare them).

    python probes/_torch_host_split.py --tree path/to/checkout --tag parent
    python probes/_torch_host_split.py --tree . --classifier --out build/clf.jsonl

For each case (B5 and B6 at the classifier's f32 shapes, UNet-64's and
ViT-S's bf16 backwards, a D = 128 forward; each f32 case on both f32
designs) one JSON line: the host's µs a call through the entry and through
its C entry alone, both timed with time.perf_counter while the card sleeps
(torch.cuda._sleep), so that no queue back-pressure is counted; the µs one
call's tensor maps take to make (``_tensor_map_probe.cu``: the same view
again, and a new view each time); a bare ctypes call; the pieces of the
Python wrapper timed alone where the tree has them; and the call's ms as
issued (CUDA events over back-to-back calls) and on the device alone.

--classifier instead runs chip_smoke.py's classifier-guided DDIM path
(``phase_classifier``) and, at one step of its second batch, records a
torch.profiler trace (``vaw_torch.utils.profiling.trace``) with each
kernel wrapper marked, then times the next steps untraced: the share of a
step's host time in the port's kernel wrappers, in eager PyTorch operators
outside them, and in neither.
"""
import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# (name, direction, dtype, B, Tq, Tk, H, D, packed views)
CASES = [
    ("B5 classifier 8px", "fwd", "float32", 4, 64, 64, 12, 64, True),
    ("B5 classifier pool", "fwd", "float32", 4, 65, 65, 12, 64, False),
    ("B6 classifier 8px", "bwd", "float32", 4, 64, 64, 12, 64, True),
    ("B6 classifier pool", "bwd", "float32", 4, 65, 65, 12, 64, False),
    ("B6 UNet-64 8x8", "bwd", "bfloat16", 128, 64, 64, 4, 96, True),
    ("B6 ViT-S", "bwd", "bfloat16", 128, 258, 258, 4, 128, True),
    ("B5 ViT-S D=128", "fwd", "bfloat16", 128, 258, 258, 4, 128, True),
]
HOST_CALLS = 200
SLEEP_CYCLES = int(4e8)  # about 0.2 s at the H100's clock


def host_us(torch, fn, n: int = HOST_CALLS) -> float:
    """Host µs a call of fn over n calls, the card held asleep so that the
    queue never fills."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def cpu_us(fn, n: int = 2000) -> float:
    """µs a call of a host-only fn."""
    for _ in range(10):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def as_issued_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_probe(root: Path, build_dir: Path) -> ctypes.CDLL:
    """The map probe, compiled with the kernels' flags against the tree's
    hopper_common.cuh."""
    from vaw_torch.ops import _build
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / "tensor_map_probe.so"
    src = Path(__file__).resolve().parent / "_tensor_map_probe.cu"
    flags = [f for f in _build.NVCC_FLAGS if f != "-v" and f != "-Xptxas"]
    subprocess.run([_build._nvcc(), *flags, "-I", str(root / "vaw_torch/ops/csrc"),
                    "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.probe_view_maps_ns.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.probe_view_maps_ns.restype = ctypes.c_double
    lib.probe_noop.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [
        ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.probe_noop.restype = ctypes.c_int
    return lib


def c_entry(fa, _build, design: str, direction: str):
    """The C entry a design launches, with its argtypes."""
    lib = _build.load_library("flash_fwd" if direction == "fwd" else "flash_bwd")
    name = {"wgmma": "_wgmma", "tf32x3": "_tf32x3"}.get(design, "")
    fn = getattr(lib, f"vaw_flash_{direction}{name}")
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    S = ctypes.POINTER(ctypes.c_longlong)
    if direction == "fwd":
        fn.argtypes = [P] * 5 + [S] + [I] * 5 + [F] + ([I] if name == "" else []) + [P]
    elif name:
        fn.argtypes = [P] * 7 + [LL] + [P] * 3 + [S] + [I] * 5 + [F, P]
    else:
        fn.argtypes = [P] * 10 + [S] + [I] * 5 + [F, I, P]
    fn.restype = I
    return fn


def run_case(torch, fa, _build, flops, probe, case, design, gen, card, tag):
    name, direction, dtype_name, b, tq, tk, h, d, packed = case
    dtype = getattr(torch, dtype_name)
    scale = 1.0 / math.sqrt(d)
    if packed:
        qkv = torch.randn((b, tq, 3, h, d), generator=gen, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        grads = torch.empty_like(qkv).unbind(2)
    else:
        q = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, tk, h, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
    dout = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v)
    views = (q, k, v) if direction == "fwd" else (q, k, v, *grads)
    got = (fa.flash_fwd_design if direction == "fwd" else fa.flash_bwd_design)(
        dtype, d, scale, views)
    if got != design:
        return None
    if direction == "fwd":
        entry = lambda: fa.flash_attention_fwd(q, k, v)  # noqa: E731
    else:
        entry = lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream
    mapped = design in ("wgmma", "tf32x3")
    strides = (fa._map_strides if mapped else fa._strides)(*views)
    fn = c_entry(fa, _build, design, direction)
    out = torch.empty((b, tq, h, d), dtype=dtype, device="cuda")
    lse2 = torch.empty((b * h, tq), dtype=torch.float32, device="cuda")
    if direction == "fwd":
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse2.data_ptr(),
                strides, b, tq, tk, h, d, scale] + ([] if mapped else [
                    int(dtype == torch.bfloat16)]) + [stream]
    else:
        inputs = [x.data_ptr() for x in (q, k, v, o, dout, lse)]
        outs = [g.data_ptr() for g in grads]
        if mapped:
            n = fa._general_bwd_scratch_floats()(b, tq, h)
            scratch = torch.empty(n, dtype=torch.float32, device="cuda")
            args = inputs + [scratch.data_ptr(), n] + outs + [strides, b, tq, tk, h, d,
                                                              scale, stream]
        else:
            delta = torch.empty((b * h, tq), dtype=torch.float32, device="cuda")
            args = inputs + [delta.data_ptr()] + outs + [strides, b, tq, tk, h, d, scale,
                                                         int(dtype == torch.bfloat16),
                                                         stream]
    call_c = lambda: fn(*args)  # noqa: E731
    check = call_c()
    if check:
        raise RuntimeError(f"{name} {design}: C entry returned {check}")
    rec = dict(tree=tag, case=name, direction=direction, dtype=dtype_name,
               shape=[b, tq, tk, h, d], packed=packed, design=design, card=card,
               entry_host_us=host_us(torch, entry), c_entry_host_us=host_us(torch, call_c),
               as_issued_ms=as_issued_ms(torch, entry), device_ms=device_ms(torch, entry))
    rec["python_us"] = rec["entry_host_us"] - rec["c_entry_host_us"]
    noop_args = [0] * 7 + [0] + [0] * 3 + [strides] + [1] * 5 + [1.0, 0]
    rec["bare_ctypes_us"] = cpu_us(lambda: probe.probe_noop(*noop_args))
    if mapped:
        # The maps one call makes: the views' own, then (bf16) dout and o,
        # (f32 backward) dout; f32 boxes of 64 query rows and 32 or 64
        # key rows in the forward, 32 rows in the backward.
        dp = 0 if dtype == torch.float32 else next(p for p in (32, 64, 80, 96, 128) if d <= p)
        isz = q.element_size()
        contiguous = (d * isz, h * d * isz, tq * h * d * isz)
        geo = [(x, x.shape[1], fa.general_tensor_map(x)[1]) for x in views]
        if direction == "bwd" and dtype == torch.bfloat16:
            geo += [(dout, tq, contiguous), (o, tq, contiguous)]
        elif direction == "bwd":
            geo = geo[:3] + [(dout, tq, contiguous)]
        if direction == "fwd" and dtype == torch.bfloat16:
            geo += [(out, tq, contiguous)]
        rows = ([64, 64 if d <= 64 else 32, 64 if d <= 64 else 32] if direction == "fwd"
                else [32] * 4)
        same = new = 0.0
        for i, (x, seq, st) in enumerate(geo):
            arr = (ctypes.c_longlong * 3)(*st)
            r = rows[i] if dp == 0 else 0
            same += probe.probe_view_maps_ns(dp, r, 2000, x.data_ptr(), 0, b, seq, h, d, arr)
            new += probe.probe_view_maps_ns(dp, r, 4096, x.data_ptr(), 1024, b, seq, h, d,
                                            arr)
        rec.update(maps_same_views_us=same / 1e3, maps_new_views_us=new / 1e3,
                   views_mapped=len(geo))
    # The wrapper's pieces, each alone, where the tree has them.
    dev = q.device
    pieces = {}
    if hasattr(fa, "_check_view") and hasattr(fa, "_check_general"):
        def checks():
            fa._check_general(b, h, d, dtype)
            for x in views:
                fa._check_view("x", x, dtype, dev)
        pieces["checks"] = cpu_us(checks)
    design_fn = fa.flash_fwd_design if direction == "fwd" else fa.flash_bwd_design
    pieces["design"] = cpu_us(lambda: design_fn(dtype, d, scale, views))
    pieces["strides"] = cpu_us(lambda: (fa._map_strides if mapped else fa._strides)(*views))
    if direction == "fwd":
        pieces["allocations"] = cpu_us(lambda: (
            torch.empty((b, tq, h, d), dtype=dtype, device=dev),
            torch.empty((b * h, tq), dtype=torch.float32, device=dev)))
    else:
        pieces["allocations"] = cpu_us(lambda: torch.empty(
            (2 * b * h * 128 * -(-tq // 128),), dtype=torch.float32, device=dev))

    def context():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream
    pieces["device_context_and_stream"] = cpu_us(context)
    pieces["current_device"] = cpu_us(torch.cuda.current_device)
    pieces["current_stream_object"] = cpu_us(lambda: torch.cuda.current_stream().cuda_stream)
    pieces["current_raw_stream"] = cpu_us(lambda: torch._C._cuda_getCurrentRawStream(0))
    pieces["flops_record"] = cpu_us(lambda: flops.record(1))
    rec["pieces_us"] = pieces
    print(json.dumps(rec), flush=True)
    return rec


def others(torch, card, tag, out_path):
    """Host µs a call and device ms of the launching wrappers this probe's
    cases leave out, at small f32 (and bf16) shapes of the classifier path:
    the p5 pair, the conv and its filter gradient, the fused pair, the fused
    bias-act; the general forward beside them."""
    from vaw_torch.ops import conv2d as conv_ops
    from vaw_torch.ops import flash_attention as fa
    from vaw_torch.ops import fused_act
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, t, h, d = 4, 256, 9, 64
    f5 = torch.randn((b, 3, h, d, t), generator=gen, device="cuda")
    o5, lse5 = fa.flash_attention_p5_fwd(f5)
    d5 = torch.randn_like(o5)
    x = torch.randn((4, 16, 16, 576), generator=gen, device="cuda")
    w = torch.randn((3, 3, 576, 576), generator=gen, device="cuda") * 0.02
    g = torch.randn((4, 16, 16, 576), generator=gen, device="cuda")
    qkv2d = torch.randn((4, 64, 3 * 12 * 64), generator=gen, device="cuda")
    of, lsef = fa._fused_forward(qkv2d, 12, 0.125)
    dof = torch.randn_like(of)
    q, k, v = torch.randn((4, 64, 3, 12, 64), generator=gen, device="cuda").unbind(2)
    xa = torch.randn((4, 64, 64, 192), generator=gen, device="cuda").to(torch.bfloat16)
    bias = torch.randn((192,), generator=gen, device="cuda").to(torch.bfloat16)
    calls = {
        "flash_attention_p5_fwd f32 (4, 256, 9, 64)": lambda: fa.flash_attention_p5_fwd(f5),
        "flash_attention_p5_bwd f32 (4, 256, 9, 64)": lambda: fa.flash_attention_p5_bwd(
            f5, o5, lse5, d5),
        "conv3x3_pallas f32 (4, 16, 16, 576->576)": lambda: conv_ops.conv3x3_pallas(x, w),
        "conv3x3_wgrad_pallas f32 (4, 16, 16, 576->576)":
            lambda: conv_ops.conv3x3_wgrad_pallas(x, g),
        "fused forward f32 (4, 64, 12, 64)": lambda: fa._fused_forward(qkv2d, 12, 0.125),
        "fused backward f32 (4, 64, 12, 64)": lambda: fa.flash_attention_fused_bwd(
            qkv2d, of, lsef, dof, 12, 0.125),
        "fused bias-act bf16 (4, 64, 64, 192)": lambda: fused_act._forward(
            xa, bias, 0.2, 2 ** 0.5),
        "flash_attention_fwd f32 (4, 64, 12, 64)": lambda: fa.flash_attention_fwd(q, k, v),
    }
    with open(out_path, "a") as f:
        for name, fn in calls.items():
            rec = dict(tree=tag, card=card, call=name, entry_host_us=host_us(torch, fn),
                       as_issued_ms=as_issued_ms(torch, fn), device_ms=device_ms(torch, fn))
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")


def classifier(args, card):
    """chip_smoke.py's classifier path with one step traced and later
    steps timed, by wrapper and by eager operator."""
    import torch
    from torch.profiler import record_function

    import chip_smoke
    from vaw_torch.core.diffusion import GaussianDiffusion
    from vaw_torch.ops import conv2d as conv_ops
    from vaw_torch.ops import flash_attention as fa
    from vaw_torch.utils.profiling import trace

    spent = {"us": 0.0, "calls": 0}

    class Marked:
        """A kernel wrapper marked in the trace and timed; attributes (the
        launch counts) go to the wrapped function."""

        def __init__(self, fn, name):
            object.__setattr__(self, "_fn", fn)
            object.__setattr__(self, "_name", f"vaw::{name}")

        def __call__(self, *a, **kw):
            t0 = time.perf_counter()
            with record_function(self._name):
                out = self._fn(*a, **kw)
            spent["us"] += (time.perf_counter() - t0) * 1e6
            spent["calls"] += 1
            return out

        def __getattr__(self, key):
            return getattr(self._fn, key)

        def __setattr__(self, key, value):
            setattr(self._fn, key, value)

    for module, names in ((fa, ("flash_attention_fwd", "flash_attention_bwd",
                                "flash_attention_p5_fwd", "flash_attention_p5_bwd")),
                          (conv_ops, ("conv3x3_pallas", "conv3x3_wgrad_pallas"))):
        for n in names:
            setattr(module, n, Marked(getattr(module, n), n))

    step_fn = GaussianDiffusion.ddim_sample
    at = chip_smoke.CLF_STEPS + 50  # step 50 of the second batch
    state = {"i": 0, "steps": []}
    logdir = Path(args.out).parent / "classifier_trace"

    def step(self, *a, **kw):
        i = state["i"]
        state["i"] += 1
        if i == at:
            torch.cuda.synchronize()
            with trace(str(logdir)) as prof:
                with record_function("vaw::step"):
                    out = step_fn(self, *a, **kw)
            state["trace"] = prof.trace_path
            return out
        if at < i <= at + 20:
            torch.cuda.synchronize()
            spent["us"], spent["calls"] = 0.0, 0
            t0 = time.perf_counter()
            out = step_fn(self, *a, **kw)
            host = (time.perf_counter() - t0) * 1e6
            torch.cuda.synchronize()
            state["steps"].append(dict(host_us=host,
                                       wall_us=(time.perf_counter() - t0) * 1e6,
                                       wrapper_us=spent["us"], wrapper_calls=spent["calls"]))
            return out
        return step_fn(self, *a, **kw)

    GaussianDiffusion.ddim_sample = step
    with tempfile.TemporaryDirectory() as tmp:
        _, _, rate = chip_smoke.phase_classifier(card, Path(tmp))
    GaussianDiffusion.ddim_sample = step_fn
    steps = state["steps"]
    mean = {k: sum(s[k] for s in steps) / len(steps) for k in steps[0]}
    events = json.loads(Path(state["trace"]).read_text())["traceEvents"]
    by_tid = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"):
            by_tid.setdefault(e["tid"], []).append(e)
    marks = [e for evs in by_tid.values() for e in evs if e["name"] == "vaw::step"]
    step0, step_us = marks[0]["ts"], marks[0]["dur"]
    wrappers = top = 0.0
    top_ops = {}
    for evs in by_tid.values():
        # The step's events on each thread (the caller's and autograd's):
        # every wrapper's mark, and the outermost events but for the step's.
        evs = sorted((e for e in evs if e["name"] != "vaw::step"
                      and step0 <= e["ts"] < step0 + step_us),
                     key=lambda e: (e["ts"], -e["dur"]))
        end = -1.0
        for e in evs:
            if e["name"].startswith("vaw::"):
                wrappers += e["dur"]
            if e["ts"] < end:
                continue
            end = e["ts"] + e["dur"]
            top += e["dur"]
            top_ops[e["name"]] = top_ops.get(e["name"], 0.0) + e["dur"]
    eager = top - wrappers
    top_ops = sorted(top_ops.items(), key=lambda kv: -kv[1])[:15]
    rec = dict(tree=args.tag or str(args.tree), card=card, samples_per_s=rate,
               untraced_steps=len(steps), untraced_mean=mean,
               untraced_wrapper_share=mean["wrapper_us"] / mean["host_us"],
               traced_step_us=step_us, traced_wrapper_us=wrappers, traced_eager_us=eager,
               traced_wrapper_share=wrappers / step_us, traced_eager_share=eager / step_us,
               traced_outermost_ops_us=top_ops)
    print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=Path("."))
    parser.add_argument("--tag", default="")
    parser.add_argument("--classifier", action="store_true")
    parser.add_argument("--others", action="store_true",
                        help="time the wrappers without a launch plan instead")
    parser.add_argument("--out", default="build/host_split.jsonl")
    args = parser.parse_args()
    root = args.tree.resolve()
    sys.path.insert(0, str(root))
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    if args.classifier:
        import chip_smoke
        chip_smoke.phase_build()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        classifier(args, card)
        return 0
    from vaw_torch.ops import _build, flops
    from vaw_torch.ops import flash_attention as fa
    if args.others:
        _build.build()
        others(torch, card, args.tag or str(args.tree), args.out)
        return 0
    _build.build(("flash_fwd", "flash_bwd"))
    probe = build_probe(root, root / "build" / "host_split_probe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    tag = args.tag or str(args.tree)
    with open(args.out, "a") as f:
        for case in CASES:
            designs = (("tf32x3", 0), ("fma", 1 << 62)) if case[2] == "float32" else (
                ("wgmma", None),)
            for design, tiles in designs:
                old = fa.TF32X3_MIN_TILES
                if tiles is not None:
                    fa.TF32X3_MIN_TILES = tiles
                try:
                    rec = run_case(torch, fa, _build, flops, probe, case, design, gen,
                                   card, tag)
                finally:
                    fa.TF32X3_MIN_TILES = old
                if rec is not None:
                    f.write(json.dumps(rec) + "\n")
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
