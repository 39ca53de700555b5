#!/usr/bin/env python3
"""The flash-attention kernels of two or more checkouts, in turns, on one
NVIDIA GPU.

    python3 chip_attn_ab.py [--cases f32,f32_long] [--case NAME=S,DTYPE,H,KVH,D,DV]
                            [--reps N] DIR [DIR ...]

Each DIR is the root of a checkout of this repository (the parent commit
and a change unpacked with ``git archive`` into a git-ignored directory,
or a copy whose ``csrc/`` was edited by hand to try a variant). Every
checkout's ``flash_attn.cu`` is built into its own library (one ``nvcc``
each, started together). For each ``chip_smoke.ATTN_CASES`` entry named
in ``--cases`` (this checkout's list), and for each causal case that
``--case`` defines (``d16=512,bfloat16,6,2,16,16``: any shape, e.g. a
width whose rows TMA takes beside one it does not), the inputs are drawn
once
(``check.make_inputs``) and the kernel this checkout's split picks is
launched through each library's C entry point: its largest difference
from the plain version is printed, and its device time (``device_ms``:
graph replays timed in turns, the checkouts' order reversed in a second
round). Every checkout must have this checkout's C interface (the f32
entry takes the wide instance's scratch and its size). One line
``attn CASE: {json}`` a case, after each library's
ptxas notes that it serialised a kernel's wgmma instructions (C7514 /
C7515: none is expected). A variant whose results are wrong on purpose
(a phase taken out to time it) still prints its time. Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="f32,f32_window,f32_long")
    ap.add_argument("--case", action="append", default=[],
                    help="NAME=S,DTYPE,H,KVH,D,DV: a causal case of its own")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_attn_ab.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attn import build, check, kernel, ref
    from repro_torch.kernels.flash_hash.check import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = {}
    for i, d in enumerate(args.dirs):
        src = (Path(d).resolve() / "src/repro_torch/kernels/flash_attn/csrc"
               / "flash_attn.cu")
        if not src.is_file():
            print(f"chip_attn_ab.py: {d} has no {src.name}", file=sys.stderr)
            return 2
        libs[f"{i}:{d}"] = nvcc.CudaLibrary(f"flash_attn_ab{i}", src,
                                            build.LIBRARY.signatures)
    nvcc.build_all(list(libs.values()))
    for label, lib in libs.items():
        # ptxas's notes that it serialised a kernel's wgmma instructions
        notes = [line for line in lib.last_build["log"].splitlines()
                 if "C7514" in line or "C7515" in line]
        print(f"ptxas {label}: {len(notes)} serialisation notes", flush=True)
        for line in notes:
            print(f"  {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    cases = {c[0]: c for c in chip_smoke.ATTN_CASES}
    names = [n for n in args.cases.split(",") if n]
    for spec in args.case:
        name, shape = spec.split("=")
        s, dtype, *heads = shape.split(",")
        cases[name] = (name, int(s), dtype, True,
                       tuple(int(x) for x in heads), 1.0)
        names.append(name)
    for name in names:
        _, s, dtype, causal, (h, kvh, d, dv), qk_scale, *w = cases[name]
        window = w[0] if w else 0
        dt = getattr(torch, dtype)
        q, k, v = check.make_inputs(1, s, h, kvh, d, dv, dt, s, dev,
                                    qk_scale)
        want = ref.sdpa_ref(q, k, v, causal=causal, window=window)
        which = kernel.kernel_for(dt, d, dv)
        entry = kernel.ENTRIES[which]
        outs, fns = {}, {}
        extra = ()
        if which == kernel.TF32X3:   # the wide instance's scratch
            n = (kernel.split_floats(1, s, h, kvh, d, dv)
                 if max(d, dv) > kernel.NARROW_MAX else 0)
            scratch = torch.empty(n, dtype=torch.float32, device=dev)
            extra = (scratch.data_ptr() if n else None, 4 * n)
        for label, lib in libs.items():
            fn = getattr(lib.load(), entry)
            o = outs[label] = torch.empty((1, s, h, dv), dtype=dt, device=dev)
            a = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, s,
                 h, kvh, d, dv, 1.0 / d ** 0.5, int(causal), window, *extra)
            fns[label] = (lambda _, fn=fn, a=a: fn(
                *a, torch.cuda.current_stream(dev).cuda_stream))
            if fns[label](0) != 0:
                raise RuntimeError(f"{label}: the launch failed")
        torch.cuda.synchronize(dev)
        errs = {label: float((o.float() - want.float()).abs().max())
                for label, o in outs.items()}
        reps = args.reps if s < 4096 else min(args.reps, 3)
        first = device_ms(fns, reps, dev)
        second = device_ms(dict(reversed(list(fns.items()))), reps, dev)
        print(f"attn {name}: " + json.dumps(
            {"kernel": which, "max_abs_err": errs, "device_ms": first,
             "device_ms_reversed": second}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
