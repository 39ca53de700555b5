#!/usr/bin/env python3
"""The serve phase of ``chip_smoke.py`` for two or more checkouts, in
turns, on one NVIDIA GPU.

    python3 chip_serve_ab.py DIR [DIR ...]

Each DIR is the root of a checkout of this repository (for example the
parent commit and the change, unpacked with ``git archive`` into a
git-ignored directory, given as ``parent change change parent``). For
each DIR in the order given, a fresh process builds that checkout's
kernels and runs its ``chip_smoke.serve_phase`` (llama3.2-3b at full
width behind ``ServeEngine`` and the prefix cache; the phase checks its
own outputs), then prints one line ``serve DIR: {json}`` with the
prefill times, the decode time per token, throughput and launch counts.
Comparing two versions only within one call keeps the card and its host
the same. Exits non-zero if any run fails or no CUDA device is present.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

KEYS = ("prefill_ms", "decode_ms_per_token", "decode_ms_mean",
        "tokens_per_s", "wall_s", "launches")


def run_one(root: str) -> None:
    """Build and serve in this process from the checkout at ``root``."""
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    import chip_smoke
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attn import build as fa_build
    from repro_torch.kernels.flash_hash import build as fh_build
    nvcc.build_all([fh_build.LIBRARY, fa_build.LIBRARY])
    out = chip_smoke.serve_phase(0, torch.device("cuda", 0))
    print(f"serve {root}: {json.dumps({k: out[k] for k in KEYS})}",
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_serve_ab.py: no CUDA device available", file=sys.stderr)
        return 2
    for d in dirs:
        root = os.path.abspath(d)
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            print(f"chip_serve_ab.py: {d} is not a checkout", file=sys.stderr)
            return 2
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
