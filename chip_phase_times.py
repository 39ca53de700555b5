#!/usr/bin/env python3
"""``chip_smoke.py`` of two or more checkouts, one after the other on one
NVIDIA GPU, with the wall time of each of its phases.

    python3 chip_phase_times.py [--logs DIR] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (for example
the parent commit and the change, unpacked with ``git archive`` into a
git-ignored directory). For each in the order given, a fresh process
imports that checkout's ``chip_smoke``, wraps each phase function it has
(``PHASES``; a nested one such as ``family_serve_phase`` is timed on its
own too, keyed by its architecture) in a timer that synchronizes the
card before it reads the clock, and runs the smoke's ``main()`` as
``python3 chip_smoke.py`` would. The smoke's own output goes to
``--logs``/``<n>.log`` (default ``artifacts/phase_times``); this
script prints one line ``phases CHECKOUT: {json}`` a run: the exit code,
the total, every phase's seconds in order and the smoke's last line.
Comparing two versions only within one call keeps the card and its host
the same. Exits non-zero if a smoke fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

#: the phase functions of ``chip_smoke`` timed when a checkout has them
PHASES = ("kernel_phase", "attention_phase", "main_path", "race_phase",
          "durability_phase", "sim_vs_card", "sharded_phase",
          "two_rank_phase", "tiny_sharded_card_vs_cpu", "precision_phase",
          "serve_phase", "f32_serve_phase", "f16_phase",
          "continuous_phase", "tiny_card_vs_cpu", "tiny_continuous",
          "families_phase", "family_serve_phase", "train_phase",
          "tiny_train_twins", "mesh_phase")


def run_one(root: str, log: str) -> int:
    """Run ``root``'s smoke in this process with its phases timed."""
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    import chip_smoke
    times = []

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            label = name
            for a in args:
                if isinstance(a, str) and " " not in a:  # arch, scheme
                    label = f"{name}:{a}"
                    break
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                times.append([label, time.perf_counter() - t0])
        return wrapper

    for name in PHASES:
        if hasattr(chip_smoke, name):
            setattr(chip_smoke, name, timed(name, getattr(chip_smoke, name)))
    sys.argv = ["chip_smoke.py"]
    t0 = time.perf_counter()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        try:
            rc = chip_smoke.main()
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except Exception:
            import traceback
            traceback.print_exc(file=f)
            rc = 1
    total = time.perf_counter() - t0
    with open(log) as f:
        lines = f.read().splitlines()
    print(f"phases {root}: " + json.dumps({
        "rc": rc, "total_s": total, "phases": times,
        "last_line": lines[-1] if lines else ""}), flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", default="artifacts/phase_times")
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("checkouts", nargs="*")
    args = ap.parse_args()
    if args.one:
        return run_one(*args.one)
    if not args.checkouts:
        ap.print_usage(sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_phase_times.py: no CUDA device available",
              file=sys.stderr)
        return 2
    logs = os.path.abspath(args.logs)
    os.makedirs(logs, exist_ok=True)
    worst = 0
    for i, d in enumerate(args.checkouts):
        root = os.path.abspath(d)
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            print(f"chip_phase_times.py: {d} is not a checkout",
                  file=sys.stderr)
            return 2
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             os.path.join(logs, f"{i}.log")], timeout=1500)
        worst = worst or proc.returncode
    return worst


if __name__ == "__main__":
    sys.exit(main())
