"""Times the port's bf16 attention entry points at the models' shapes, and
hashes what they return, with the ``vaw_torch`` of the checkout named by
--tree. Run it on two checkouts in one call on the card, in the order A, B,
B, A, to compare their kernels: equal hashes mean bit-equal outputs.

    python probes/_torch_attention_ab.py --tree path/to/checkout --tag parent
    python probes/_torch_attention_ab.py --tree path/to/checkout --set wide

Prints the card's name and power limit, then one JSON line a shape: the
forward's and the backward's ms a call as issued (CUDA events over
back-to-back calls after a warm-up), on the device alone (the same calls
queued while the card sleeps, then run back to back between two events),
the host's µs a call (time.perf_counter over calls queued while the card
sleeps), and the first 12 hex digits of the SHA-1 of o, lse and the
gradient. --set picks the shapes: "xl" (the default) or "wide",
the head dims 96 and 128 beside the D <= 80 shapes whose outputs a change
to the backwards must keep ("wide_new": the first five alone); "f32_bwd",
the f32 shapes of the two 3xTF32 backward pairs (the d-major p5 pair at
LDM's and the classifier's shapes, the general pair on packed views);
"mma_fma", bf16 and f32 calls on the mma.sync, FMA and 3xTF32 kernels;
"consumers", the bf16 forward alone at the D <= 64 shapes of the wgmma
forward's consumer rule (flash_attention.flash_fwd_consumers), once for
each consumer count where the tree chooses one per call (2 and 3, each
forced on every call by patching the rule, then the rule's own) and once
as the tree runs it otherwise. --profile
adds, for each shape, the device time of each kernel of one backward
(torch.profiler over 10 calls).
--errors adds, for each shape, the max abs and root mean square errors of
o, and of dq, dk and dv over max|grad|, against the f32 plain version on
the same bf16 inputs (upcast), and SDPA's and its backward's on the same
inputs, with the kernel's over SDPA's (chip_smoke.py:attention_errors,
imported from this checkout's chip_smoke.py over the tree's vaw_torch),
and lse's max abs error; --draws N makes it N draws of the inputs, the
timed ones first (the design gate's spread: the max error of a bf16 output
is mostly its own rounding, so one draw says little). The hi + lo backward
is a tree of its own (probes/_torch_bwd_variant.py --variant hilo).
--summary FILE... reads such lines (of one tree each) and prints, for
each tree, padded head dim and output, the median and the largest of the
kernel's error over SDPA's across shapes and draws, max and rms.
--key-tile forces the wgmma forward's keys a tile (64, or 128 where the
head dim is at most 64 and the call runs two consumer warpgroups;
flash_attention.flash_fwd_key_tile) on every call, on a tree that chooses
it per call.
--sdpa adds, for each shape, SDPA's and its backward's ms a call as issued
and on the device alone, and the least time of each direction (the bytes
each input is read and each output written once, or the products at the
bf16 tensor-core peak, whichever binds; chip_smoke.py's bounds).
--build-only builds the tree's attention kernels, prints the registers and
spill stores of each wgmma instantiation (ptxas -v) and stops, so that
several trees can build side by side before any is timed.
"""
import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

# (entry, B, T, H, D): "general" is q, k and v as views of one packed
# [B, T, 3, H, D] row through flash_attention_fwd / _bwd (U-ViT, ViT, the
# UNet's levels off T = 256); "fused" the packed projection [B, T, 3*H*D]
# through flash_attention_fused / _fused_bwd (the DiT). The sampling batch
# 128 (64 samples with CFG).
SHAPES = {
    "xl": [("general", 128, 1024, 6, 64), ("general", 128, 258, 16, 64),
           ("general", 128, 1024, 8, 32), ("general", 32, 256, 8, 128),
           ("general", 128, 258, 16, 72), ("fused", 128, 256, 12, 64),
           ("fused", 128, 256, 16, 72)],
    # "p5" is the d-major [B, 3, H, D, T] through flash_attention_p5_fwd /
    # _bwd (the UNet's T = 256 levels, and DiT-XL/2's under
    # VAW_FUSED_TMAJOR=0). ViT-S (T = 258, 4 heads of 128) and UNet-64 (4
    # heads of 96 at T = 256 and 64) at batch 128; then the shapes at D <= 80
    # of chip_smoke.py's backward phases.
    "wide": [("general", 128, 258, 4, 128), ("general", 128, 64, 4, 96),
             ("p5", 128, 256, 4, 96), ("p5", 128, 256, 16, 72),
             ("fused", 16, 256, 6, 128), ("general", 128, 258, 16, 64),
             ("general", 16, 258, 12, 72), ("general", 128, 1024, 8, 32),
             ("general", 128, 64, 32, 32), ("general", 16, 64, 12, 64),
             ("fused", 256, 256, 12, 64), ("fused", 128, 256, 16, 72),
             ("p5", 256, 256, 16, 32), ("p5", 4, 256, 9, 64), ("p5", 2, 256, 8, 16)],
}
SHAPES["wide_new"] = SHAPES["wide"][:5]
# The design gate's shapes: every bf16 model shape of the general wgmma
# pair (the general and the fused entries) at each padded head dim, 32 (LDM,
# MM-DiT-B/2), 64 (DiT-B/2 sampling and training, U-ViT-L/2, ViT-B/2,
# ADM-64), 80 (D = 72: U-ViT-H/2, DiT-XL/2), 96 (UNet-64) and 128 (ViT-S).
SHAPES["gate"] = [("general", 128, 1024, 8, 32), ("general", 128, 257, 24, 32),
                  ("general", 128, 64, 32, 32), ("fused", 128, 256, 12, 64),
                  ("fused", 256, 256, 12, 64), ("general", 128, 258, 16, 64),
                  ("general", 128, 258, 12, 64), ("general", 128, 1024, 6, 64),
                  ("general", 16, 64, 12, 64), ("general", 128, 258, 16, 72),
                  ("fused", 128, 256, 16, 72), ("general", 16, 258, 12, 72),
                  ("general", 128, 64, 4, 96), ("general", 128, 258, 4, 128),
                  ("fused", 16, 256, 6, 128), ("general", 32, 256, 8, 128)]
SHAPES["f32_bwd"] = [("p5", 128, 256, 16, 32), ("p5", 4, 256, 9, 64),
                     ("general", 4, 1024, 6, 64)]
# DiT-B/2 (sampling with CFG, training), U-ViT-L/2, ViT-B/2, MM-DiT-B/2,
# and LDM's and ADM-64's T = 1024 and T = 64 blocks, at the sampling batch.
SHAPES["consumers"] = [("fused", 128, 256, 12, 64), ("fused", 256, 256, 12, 64),
                       ("general", 128, 258, 16, 64), ("general", 128, 258, 12, 64),
                       ("general", 128, 257, 24, 32), ("general", 128, 1024, 8, 32),
                       ("general", 128, 64, 32, 32), ("general", 128, 1024, 6, 64),
                       ("general", 128, 64, 12, 64)]
# Calls on the kernels no bf16 wgmma rule reaches, whose outputs a change to
# the bf16 wgmma pair must keep bit-equal: bf16 at D = 256 (mma.sync both
# ways), f32 at D = 128 (3xTF32 forward, FMA backward) and the fused f32
# D = 72 (3xTF32 forward on the views, the fused FMA backward). A sixth
# item is the shape's dtype.
SHAPES["mma_fma"] = [("general", 8, 258, 4, 256), ("general", 4, 256, 4, 128, "float32"),
                     ("fused", 4, 256, 4, 72, "float32")]
DTYPES = {"f32_bwd": "float32"}
SOURCES = ("flash_fwd", "flash_bwd", "flash_fused_fwd", "flash_fused_bwd", "flash_p5_fwd",
           "flash_p5_bwd")


def ms_a_call(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """ms a call on the device alone: the card sleeps (about 50 ms) while
    the host queues the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(1e8))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters: int) -> float:
    """The host's µs a call, the calls queued while the card sleeps."""
    import time
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / iters * 1e6


def kernel_ms(torch, fn, calls: int) -> dict:
    """Device ms of each kernel a call of fn launches, from torch.profiler's
    device time summed over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None)
        if total is None:
            total = event.cuda_time_total
        if total > 0:
            out[event.key[:100]] = total / 1e3 / calls
    return out


def digest(torch, *tensors) -> str:
    h = hashlib.sha1()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def errors(entry, qkv, dout, o, lse, grad) -> dict:
    """The kernel's and SDPA's errors against the f32 plain version on the
    same bf16 inputs (chip_smoke.py:attention_errors: o, and each gradient
    over its max|grad|, max and rms), lse's max abs error, and the kernel's
    over SDPA's for each."""
    from chip_smoke import attention_errors

    b, t, _, h, d = qkv.shape
    if entry == "p5":
        o4 = o.view(b, h, d, t).permute(0, 3, 1, 2)
        g5 = grad.permute(0, 4, 1, 2, 3)
    else:
        o4 = o.view(b, t, h, d)
        g5 = grad.view(b, t, 3, h, d)
    kernel, sdpa, (_, rlse) = attention_errors(*qkv.unbind(2), o4, dout, g5.unbind(2))
    lse_err = (lse - rlse).abs().max().item()
    del rlse
    return dict(kernel=kernel, sdpa=sdpa, lse=lse_err,
                over_sdpa={k: {s: kernel[k][s] / sdpa[k][s] if sdpa[k][s] else None
                               for s in kernel[k]} for k in sdpa})


def sdpa_times(torch, qkv, dout) -> dict:
    """SDPA's forward and backward (from a retained graph) on the q, k and v
    views of qkv, ms a call as issued and on the device alone, beside the
    bounds of chip_smoke.py:attention_bound_ms and attention_bwd_bound_ms
    (H100 SXM: 3.35 TB/s, 989 TFLOP/s in bf16)."""
    import torch.nn.functional as F

    b, t, _, h, d = qkv.shape
    leaf = qkv.detach().requires_grad_(True)
    qh, kh, vh = (x.transpose(1, 2) for x in leaf.unbind(2))
    fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
    out = fwd()
    g = dout.transpose(1, 2)
    bwd = lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)  # noqa: E731
    elt = qkv.element_size()
    fwd_bytes = 4 * b * t * h * d * elt + b * h * t * 4
    bwd_bytes = 8 * b * t * h * d * elt + b * h * t * 4
    ops = 4 * b * h * t * t * d
    return dict(sdpa_fwd_ms=ms_a_call(torch, fwd, 20), sdpa_fwd_device_ms=device_ms(torch, fwd, 20),
                sdpa_bwd_ms=ms_a_call(torch, bwd, 10), sdpa_bwd_device_ms=device_ms(torch, bwd, 10),
                fwd_bound_ms=max(fwd_bytes / 3.35e9, ops / 989e9),
                bwd_bound_ms=max(bwd_bytes / 3.35e9, 2.5 * ops / 989e9))


def force(fa, key_tile):
    """Patches the tree's per-call key tile to the forced one (None keeps
    the rule); a tree without the rule is left as it is."""
    if key_tile is not None and hasattr(fa, "flash_fwd_key_tile"):
        fa.flash_fwd_key_tile = lambda tq, tk, dp: (
            key_tile if dp <= 64 and fa.flash_fwd_consumers(tq, dp) == 2 else 64)
    fa._plans.clear()


def build_log(_build):
    """Builds the attention sources and prints each wgmma instantiation's
    registers and spill stores."""
    logs = _build.build(SOURCES)
    for name, log in logs.items():
        for entry in log.split("Compiling entry function")[1:]:
            kernel = re.search(r"((?:flash_fwd|flash_bwd_dq|flash_bwd_dkdv|flash_p5_fwd|"
                               r"flash_p5_bwd_dq|flash_p5_bwd_dkdv)_wgmma)I(\w+?)EEv", entry)
            if kernel:
                args = ", ".join(re.findall(r"L[ib](\d+)E", kernel.group(2)))
                used = re.search(r"Used (\d+) registers", entry).group(1)
                spilled = re.search(r"(\d+) bytes spill stores", entry).group(1)
                print(f"[build] {name}: {kernel.group(1)}<{args}>: {used} registers, "
                      f"{spilled} bytes spill stores", flush=True)


def forward_of(fa, entry, qkv, h):
    """The forward call of `entry` on the packed qkv [B, T, 3, H, D]."""
    b, t, _, _, d = qkv.shape
    if entry == "fused":
        f = qkv.view(b, t, 3 * h * d)
        return lambda: fa.flash_attention_fused(f, h)
    q, k, v = qkv.unbind(2)
    return lambda: fa.flash_attention_fwd(q, k, v)


def time_consumers(torch, fa, entry, shape, card, tag):
    """One JSON line for each consumer count of the bf16 forward at
    `shape`: 2 and 3 forced through the rule, then the rule's own; one line
    as the tree runs it where the tree has no per-call count."""
    b, t, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    rule = getattr(fa, "flash_fwd_consumers", None)
    counts = (2, 3, None) if rule else (None,)
    for n in counts:
        if n is not None:
            fa.flash_fwd_consumers = lambda tq, dp, n=n: n if dp <= 64 else 2
        fa._plans.clear()
        try:
            fwd = forward_of(fa, entry, qkv, h)
            o, lse = fwd()
            torch.cuda.synchronize()
            chosen = n if n is not None else (rule(t, fa._wgmma_dp(d)) if rule else None)
            tile = getattr(fa, "flash_fwd_key_tile", None)
            print(json.dumps(dict(
                tree=tag, entry=entry, shape=[b, t, h, d],
                consumers=chosen, by="forced" if n is not None else "rule",
                key_tile=tile(t, t, fa._wgmma_dp(d)) if tile else 64,
                fwd_ms=ms_a_call(torch, fwd, 50), fwd_ms_2=ms_a_call(torch, fwd, 50),
                fwd_device_ms=device_ms(torch, fwd, 20),
                fwd_device_ms_2=device_ms(torch, fwd, 20),
                fwd_sha=digest(torch, o, lse), card=card)), flush=True)
            del o, lse
        finally:
            if rule:
                fa.flash_fwd_consumers = rule
            fa._plans.clear()
    del qkv
    torch.cuda.empty_cache()


def entry_calls(torch, fa, entry, qkv, dout):
    """The forward and backward calls of `entry` on the packed qkv [B, T,
    3, H, D] and dout [B, T, H, D], each run once: (fwd, bwd, (o, lse,
    grad)), grad laid out as the entry returns it (the general entry's
    [B, T, 3, H, D])."""
    b, t, _, h, d = qkv.shape
    if entry == "p5":
        f5 = qkv.permute(0, 2, 3, 4, 1).contiguous()
        d5 = dout.permute(0, 2, 3, 1).reshape(b * h, d, t).contiguous()
        fwd = lambda: fa.flash_attention_p5_fwd(f5)  # noqa: E731
        o, lse = fwd()
        bwd = lambda: fa.flash_attention_p5_bwd(f5, o, lse, d5)  # noqa: E731
        grad = bwd()
    elif entry == "fused":
        f, d2 = qkv.view(b, t, 3 * h * d), dout.view(b, t, h * d)
        fwd = lambda: fa.flash_attention_fused(f, h)  # noqa: E731
        o, lse = fwd()
        bwd = lambda: fa.flash_attention_fused_bwd(f, o, lse, d2, h)  # noqa: E731
        grad = bwd()
    else:
        q, k, v = qkv.unbind(2)
        fwd = lambda: fa.flash_attention_fwd(q, k, v)  # noqa: E731
        o, lse = fwd()
        grad = torch.empty_like(qkv)
        bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, dout, grads=grad.unbind(2))
        bwd()
    torch.cuda.synchronize()
    return fwd, bwd, (o, lse, grad)


def summary(paths) -> None:
    """Per tree, padded head dim (the backward pair's: 32, 64, 80, 96, 128)
    and output: the median and largest of the kernel's error over SDPA's
    across the shapes and draws of --errors lines, max and rms."""
    import statistics

    ratios = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            dp = next(w for w in (32, 64, 80, 96, 128) if r["shape"][3] <= w)
            for draw in r.get("draws", []):
                for name, over in draw["over_sdpa"].items():
                    for stat, x in over.items():
                        ratios.setdefault((r["tree"], dp, name, stat), []).append(x)
    for (tree, dp, name, stat), xs in sorted(ratios.items()):
        print(json.dumps(dict(tree=tree, dp=dp, output=name, stat=stat, n=len(xs),
                              median=statistics.median(xs), largest=max(xs))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path)
    parser.add_argument("--summary", nargs="+", metavar="FILE")
    parser.add_argument("--tag", default="")
    parser.add_argument("--set", default="xl", choices=sorted(SHAPES))
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--errors", action="store_true")
    parser.add_argument("--sdpa", action="store_true")
    parser.add_argument("--draws", type=int, default=1,
                        help="draws of the inputs for --errors")
    parser.add_argument("--key-tile", type=int, choices=(64, 128))
    parser.add_argument("--build-only", action="store_true",
                        help="build the tree's attention kernels and stop")
    args = parser.parse_args()
    if args.summary:
        summary(args.summary)
        return 0
    if args.tree is None:
        parser.error("--tree is required")
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    from vaw_torch.ops import _build
    from vaw_torch.ops import flash_attention as fa

    if args.build_only:
        build_log(_build)
        return 0
    force(fa, args.key_tile)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    tag = args.tag or str(args.tree)
    if args.key_tile:
        tag += f" key_tile={args.key_tile}"
    if args.errors:
        # chip_smoke.py of this checkout, over the tree's vaw_torch.
        sys.path.append(str(Path(__file__).resolve().parents[1]))
    if args.set == "consumers":
        for entry, b, t, h, d in SHAPES[args.set]:
            time_consumers(torch, fa, entry, (b, t, h, d), card, tag)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for index, (entry, b, t, h, d, *own) in enumerate(SHAPES[args.set]):
        dtype = getattr(torch, own[0] if own else DTYPES.get(args.set, "bfloat16"))
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(dtype)
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
        fwd, bwd, (o, lse, grad) = entry_calls(torch, fa, entry, qkv, dout)
        kernels = kernel_ms(torch, bwd, 10) if args.profile else {}
        errs = []
        if args.errors:
            errs.append(errors(entry, qkv, dout, o, lse, grad))
            own_gen = torch.Generator(device="cuda").manual_seed(1000 + index)
            for _ in range(args.draws - 1):
                x = torch.randn((b, t, 3, h, d), generator=own_gen, device="cuda").to(dtype)
                dx = torch.randn((b, t, h, d), generator=own_gen, device="cuda").to(dtype)
                errs.append(errors(entry, x, dx, *entry_calls(torch, fa, entry, x, dx)[2]))
                del x, dx
        library = sdpa_times(torch, qkv, dout) if args.sdpa else {}
        print(json.dumps(dict(
            tree=tag, entry=entry, shape=[b, t, h, d],
            dtype=str(dtype)[6:],
            fwd_ms=ms_a_call(torch, fwd, 50), bwd_ms=ms_a_call(torch, bwd, 20),
            fwd_device_ms=device_ms(torch, fwd, 20), bwd_device_ms=device_ms(torch, bwd, 20),
            fwd_host_us=host_us(torch, fwd, 20), bwd_host_us=host_us(torch, bwd, 20),
            fwd_sha=digest(torch, o, lse), bwd_sha=digest(torch, grad), card=card,
            **({"bwd_kernel_ms": kernels} if kernels else {}),
            **({"errors": errs[0], "draws": errs} if errs else {}), **library)),
            flush=True)
        del qkv, dout, o, lse, grad, fwd, bwd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
