"""Writes a copy of the port with one design choice of the wgmma attention
backwards changed, for timing the two against each other with
probes/_torch_attention_ab.py on the card:

    python probes/_torch_bwd_variant.py --variant pad128 --out build/pad128
    python probes/_torch_attention_ab.py --tree build/pad128 --set wide --tag pad128

The copy holds vaw_torch/ and pyproject.toml (so its kernels build into
its own build/), with these lines of csrc/ changed:

- pad128: the general pair's C entry sends D <= 88 to the 96-wide tiles and
  96 to the 128-wide ones (two 128-byte slabs, TMA's zero fill past D);
- pipelined: both dQ kernels issue key tile j's S and dP before tile j-1's
  dS k at every head dim, as they do up to DP = 80 (general) and 64 (p5);
- regs240: setmaxnreg leaves a producer warpgroup 24 registers a thread and
  the consumers 240 (24 + 2 * 240 = 3 * 168), in both files;
- unsplit96: the general dK/dV kernel gives one warpgroup both dK and dV
  of 64 keys at DP = 96 too (items of 128 keys), as it does up to DP = 80,
  instead of a warpgroup each (dkdv_split);
- hilo: the general pair takes P^T and dS as bf16 hi + lo (two terms,
  each product run twice), as it did before the one-term design
  (kBwdTerms).

    python probes/_torch_bwd_variant.py --variant hilo --out build/hilo
    python probes/_torch_attention_ab.py --tree build/hilo --set xl --errors --draws 8
"""
import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("vaw_torch") / "ops" / "csrc"
VARIANTS = {
    "pad128": [("flash_bwd.cu", "  if (dim <= 96) {\n    return launch_wgmma<96>(",
                "  if (dim <= 88) {\n    return launch_wgmma<96>(")],
    "pipelined": [("flash_bwd.cu", "constexpr bool dq_pipelined() { return DP <= 80; }",
                   "constexpr bool dq_pipelined() { return DP <= 128; }"),
                  ("flash_p5_bwd.cu", "constexpr bool dq_pipelined() { return DP <= 64; }",
                   "constexpr bool dq_pipelined() { return DP <= 128; }")],
    "hilo": [("flash_bwd.cu", "constexpr int kBwdTerms = 1;", "constexpr int kBwdTerms = 2;")],
    "unsplit96": [("flash_bwd.cu", "constexpr bool dkdv_split() { return DP > 80; }",
                   "constexpr bool dkdv_split() { return DP > 96; }")],
    "regs240": [(name, old, new) for name in ("flash_bwd.cu", "flash_p5_bwd.cu")
                for old, new in (("constexpr int kProducerRegs = 56;",
                                  "constexpr int kProducerRegs = 24;"),
                                 ("constexpr int kConsumerRegs = 224;",
                                  "constexpr int kConsumerRegs = 240;"))],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    parser.add_argument("--out", type=Path, required=True)
    args = parser.parse_args()
    if args.out.exists():
        shutil.rmtree(args.out)
    shutil.copytree(ROOT / "vaw_torch", args.out / "vaw_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "pyproject.toml", args.out / "pyproject.toml")
    for name, old, new in VARIANTS[args.variant]:
        source = args.out / CSRC / name
        text = source.read_text()
        if text.count(old) != 1:
            print(f"{name}: {old!r} was not found once", file=sys.stderr)
            return 1
        source.write_text(text.replace(old, new))
    print(f"wrote {args.out}: {args.variant}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
