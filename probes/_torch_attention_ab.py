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
to the backwards must keep ("wide_new": the first five alone). --profile
adds, for each shape, the device time of each kernel of one backward
(torch.profiler over 10 calls).
--build-only builds the tree's attention kernels and stops, so that several
trees can build side by side before any is timed.
"""
import argparse
import hashlib
import json
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
            out[event.key[:60]] = total / 1e3 / calls
    return out


def digest(torch, *tensors) -> str:
    h = hashlib.sha1()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, required=True)
    parser.add_argument("--tag", default="")
    parser.add_argument("--set", default="xl", choices=sorted(SHAPES))
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--build-only", action="store_true",
                        help="build the tree's attention kernels and stop")
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    from vaw_torch.ops import _build
    from vaw_torch.ops import flash_attention as fa

    if args.build_only:
        _build.build(SOURCES)
        return 0

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for entry, b, t, h, d in SHAPES[args.set]:
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        if entry == "p5":
            f5 = qkv.permute(0, 2, 3, 4, 1).contiguous()
            d5 = dout.permute(0, 2, 3, 1).reshape(b * h, d, t).contiguous()
            fwd = lambda: fa.flash_attention_p5_fwd(f5)
            o, lse = fwd()
            bwd = lambda: fa.flash_attention_p5_bwd(f5, o, lse, d5)
            grad = bwd()
        elif entry == "fused":
            f, d2 = qkv.view(b, t, 3 * h * d), dout.view(b, t, h * d)
            fwd = lambda: fa.flash_attention_fused(f, h)
            o, lse = fwd()
            bwd = lambda: fa.flash_attention_fused_bwd(f, o, lse, d2, h)
            grad = bwd()
        else:
            q, k, v = qkv.unbind(2)
            fwd = lambda: fa.flash_attention_fwd(q, k, v)
            o, lse = fwd()
            grad = torch.empty_like(qkv)
            bwd = lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout, grads=grad.unbind(2))
            bwd()
        torch.cuda.synchronize()
        kernels = kernel_ms(torch, bwd, 10) if args.profile else {}
        print(json.dumps(dict(
            tree=args.tag or str(args.tree), entry=entry, shape=[b, t, h, d],
            fwd_ms=ms_a_call(torch, fwd, 50), bwd_ms=ms_a_call(torch, bwd, 20),
            fwd_device_ms=device_ms(torch, fwd, 20), bwd_device_ms=device_ms(torch, bwd, 20),
            fwd_host_us=host_us(torch, fwd, 20), bwd_host_us=host_us(torch, bwd, 20),
            fwd_sha=digest(torch, o, lse), bwd_sha=digest(torch, grad), card=card,
            **({"bwd_kernel_ms": kernels} if kernels else {}))),
            flush=True)
        del qkv, dout, o, lse, grad
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
