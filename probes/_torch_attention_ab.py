"""Times the port's bf16 attention entry points at the models' shapes, and
hashes what they return, with the ``vaw_torch`` of the checkout named by
--tree. Run it on two checkouts in one call on the card, in the order A, B,
B, A, to compare their kernels: equal hashes mean bit-equal outputs.

    python probes/_torch_attention_ab.py --tree path/to/checkout --tag parent

Prints the card's name and power limit, then one JSON line a shape: the
forward's and the backward's ms a call (CUDA events over back-to-back
calls after a warm-up) and the first 12 hex digits of the SHA-1 of o, lse
and the gradient.
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
SHAPES = [("general", 128, 1024, 6, 64), ("general", 128, 258, 16, 64),
          ("general", 128, 1024, 8, 32), ("general", 32, 256, 8, 128),
          ("general", 128, 258, 16, 72), ("fused", 128, 256, 12, 64),
          ("fused", 128, 256, 16, 72)]


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


def digest(torch, *tensors) -> str:
    h = hashlib.sha1()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, required=True)
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    from vaw_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for entry, b, t, h, d in SHAPES:
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        if entry == "fused":
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
        print(json.dumps(dict(
            tree=args.tag or str(args.tree), entry=entry, shape=[b, t, h, d],
            fwd_ms=ms_a_call(torch, fwd, 50), bwd_ms=ms_a_call(torch, bwd, 20),
            fwd_sha=digest(torch, o, lse), bwd_sha=digest(torch, grad), card=card)),
            flush=True)
        del qkv, dout, o, lse, grad
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
