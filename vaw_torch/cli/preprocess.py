"""Preprocessing entry point (counterpart of vaw_tpu/cli/preprocess.py;
reference: preprocessing/*.py).

    python -m vaw_torch.cli.preprocess encode-latents --input ./imagenet --output latents.h5

``encode-latents`` runs on the first CUDA card (``VAW_PLATFORM=cpu`` selects
the CPU) with the SD-VAE checkpoint that ``VAW_VAE_PATH`` names or that lies
under ``pretrained/``. The parser takes the JAX CLI's other subcommands
(resize-imagenet, celeba, lsun, ref-stats) with their flags, and they raise:
they are not ported yet (ROADMAP A17).
"""

from __future__ import annotations

import argparse

from ..data.preprocessing import encode_latents
from .sample import select_device

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description="vaw_torch preprocessing tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    el = sub.add_parser("encode-latents")
    el.add_argument("--input", required=True)
    el.add_argument("--output", required=True)
    el.add_argument("--image_size", type=int, default=256)
    el.add_argument("--vae", choices=["ema", "mse"], default="ema")
    el.add_argument("--batch_size", type=int, default=64)
    el.add_argument("--save_pixels", action="store_true")

    ri = sub.add_parser("resize-imagenet")
    ri.add_argument("--input", required=True)
    ri.add_argument("--output", required=True)
    ri.add_argument("--image_size", type=int, default=64)
    ri.add_argument("--workers", type=int, default=16)

    ce = sub.add_parser("celeba")
    ce.add_argument("--input", required=True)
    ce.add_argument("--output", required=True)
    ce.add_argument("--image_size", type=int, default=64)
    ce.add_argument("--crop", type=int, default=140)

    ls = sub.add_parser("lsun")
    ls.add_argument("--input", required=True)
    ls.add_argument("--output", required=True)
    ls.add_argument("--image_size", type=int, default=256)
    ls.add_argument("--limit", type=int, default=None)

    rs = sub.add_parser("ref-stats")
    rs.add_argument("--input", required=True)
    rs.add_argument("--name", required=True)
    rs.add_argument("--image_size", type=int, default=32)
    rs.add_argument("--batch_size", type=int, default=64)
    rs.add_argument("--output", default=None)

    args = p.parse_args(argv)
    if args.cmd != "encode-latents":
        raise NotImplementedError(
            f"preprocess {args.cmd} is not ported yet: ROADMAP A17")
    out = encode_latents(args.input, args.output, args.image_size, args.vae,
                         args.batch_size, args.save_pixels, device=select_device())
    print(out)
    return out


if __name__ == "__main__":
    main()
