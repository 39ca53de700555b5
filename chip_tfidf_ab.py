#!/usr/bin/env python3
"""The MB and MDB TF-IDF runs of ``chip_smoke.py`` for two or more
checkouts, in turns, on one NVIDIA GPU; and the merges of those runs
replayed through the parallel and the serial merge kernel.

    python3 chip_tfidf_ab.py DIR [DIR ...]
    python3 chip_tfidf_ab.py --replay

Each DIR is the root of a checkout of this repository (for example the
parent commit and the change, unpacked with ``git archive`` into a
git-ignored directory, given as ``parent change change parent``). For
each DIR in the order given, a fresh process builds that checkout's
flash-hash kernels and runs its ``chip_smoke.main_path`` for MB and MDB
at 2**20 slots on 2**21 tokens (the smoke's seed; each run checks its
answers against the stream), then prints one line per run ``tfidf DIR
SCHEME: {json}`` with the ingest and lookup rates, the time the ingest
waited on the drain worker and the worker's busy time, the host seconds
spent in merge calls (``ops.merge_dirty``, its checks' sync included)
and their number, the wear ledger and the launch counts. A DIR written
``DIR@serial`` runs that checkout with the serial merge kernel on the
path in place of the parallel fold (a checkout that has both).
Comparing versions only within one call keeps the card and its host the
same. Last, ``summary SCHEME: {json}`` gives each DIR's ingest rates
(median and quartiles) and, taking the DIRs two by two in the order
given as pairs, how many pairs each DIR read the higher ingest rate.

``--replay`` runs MB and MDB once in this checkout, keeping a copy of
the inputs of every ``merge_dirty`` launch (the table as it stood, the
listed blocks, the update rows), then times each launch again in turns
(``check.merge_in_turns``: kernel-only CUDA-event medians of the
parallel fold and of the serial kernel, each call on its own copy of
the table) and prints ``replay SCHEME: {json}``: the launches, their
rows and updates, the mean load of the listed tiles, the summed
kernel-only times of both kernels over the run's launches, and the
largest difference between the two kernels' outputs (0 is required).

Exits non-zero if any run fails or no CUDA device is present.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

KEYS = ("ingest_s", "ingest_tokens_per_s", "lookup_keys_per_s",
        "write_stall_us", "write_overlap_us", "wear", "launches",
        "load_factor")
SCHEMES = ("MB", "MDB")
#: rounds of :func:`check.in_turns` per replayed launch
REPLAY_REPS = 5


def _setup(root: str):
    """Import ``root``'s ``chip_smoke`` and build its flash-hash kernels."""
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_hash import build as fh_build
    nvcc.build_all([fh_build.LIBRARY])
    return chip_smoke


def run_one(job: str) -> None:
    """MB and MDB in this process from the checkout ``job`` names."""
    import time

    import torch
    root, _, arm = job.partition("@")
    smoke = _setup(root)
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.kernels.flash_hash import ops
    if arm == "serial":
        # the path's blocks of 1,024 slots take the staged route
        K.MERGE_ENTRIES["staged"] = K.MERGE_ENTRIES["serial"]
    merge = ops.merge_dirty
    spent = {"merge_s": 0.0, "merge_calls": 0}

    def clocked(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return merge(*args, **kwargs)
        finally:
            spent["merge_s"] += time.perf_counter() - t0
            spent["merge_calls"] += 1

    ops.merge_dirty = clocked
    dev = torch.device("cuda", 0)
    for scheme in SCHEMES:
        spent.update(merge_s=0.0, merge_calls=0)
        out = smoke.main_path(scheme, smoke.SMALL, 1, dev)
        rec = {**{k: out[k] for k in KEYS}, **spent}
        print(f"tfidf {job} {scheme}: {json.dumps(rec)}", flush=True)


def replay(root: str) -> None:
    """MB and MDB with every merge launch's inputs kept, then each launch
    timed in turns through both merge kernels."""
    import torch
    smoke = _setup(root)
    from repro_torch.kernels.flash_hash import check as C
    from repro_torch.kernels.flash_hash import kernel as K
    dev = torch.device("cuda", 0)
    launch = K._launch_merge_dirty
    kept = []

    def keep(pair, keys, counts, filt, ids, uk, uc, *rest):
        kept.append((pair, [keys.clone(), counts.clone(), filt.clone()],
                     ids.clone(), uk.clone(), uc.clone()))
        return launch(pair, keys, counts, filt, ids, uk, uc, *rest)

    for scheme in SCHEMES:
        kept.clear()
        K._launch_merge_dirty = keep
        try:
            smoke.main_path(scheme, smoke.SMALL, 1, dev)
        finally:
            K._launch_merge_dirty = launch
        rec = {"launches": len(kept), "rows": 0, "updates": 0, "ms": 0.0,
               "serial_ms": 0.0, "max_abs_err": 0}
        loads = []
        for pair, table, ids, uk, uc in kept:
            res = C._counted(lambda: C.merge_in_turns(
                pair, table, ids, uk, uc, REPLAY_REPS))
            rec["max_abs_err"] = max(rec["max_abs_err"], C._max_err(
                res["per_row_out"], res["serial_out"]))
            rec["ms"] += res["ms"]
            rec["serial_ms"] += res["serial_ms"]
            rec["rows"] += int(ids.numel())
            rec["updates"] += int((uk != K.EMPTY).sum())
            loads.append(float((table[0][ids.long()] != K.EMPTY)
                               .float().mean()))
        rec["mean_listed_tile_load"] = sum(loads) / max(len(loads), 1)
        print(f"replay {scheme}: {json.dumps(rec)}", flush=True)
        if rec["max_abs_err"] != 0:
            raise RuntimeError(f"replay {scheme}: the parallel and the "
                               "serial merge kernel disagree")
        del kept[:]
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--one", "--replay-in"):
        (run_one if sys.argv[1] == "--one" else replay)(sys.argv[2])
        return 0
    args = sys.argv[1:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_tfidf_ab.py: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    jobs = ([("--replay-in", here)] if args == ["--replay"] else
            [("--one", os.path.abspath(d)) for d in args])
    rates = []              # per job: {scheme: ingest tokens/s}
    for flag, job in jobs:
        root = job.partition("@")[0]
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            print(f"chip_tfidf_ab.py: {root} is not a checkout",
                  file=sys.stderr)
            return 2
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               flag, job], timeout=900,
                              stdout=subprocess.PIPE, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            return proc.returncode
        rates.append({})
        for line in proc.stdout.splitlines():
            if line.startswith(f"tfidf {job} "):
                scheme, rec = line[len(f"tfidf {job} "):].split(": ", 1)
                rates[-1][scheme] = json.loads(rec)["ingest_tokens_per_s"]
    if flag == "--one":
        summarize(rates, [root for _, root in jobs])
    return 0


def summarize(rates, order) -> None:
    """Print each scheme's ingest rates per checkout (``rates[i]`` is
    job ``i``'s, run from ``order[i]``) and its pair wins."""
    import statistics
    for scheme in SCHEMES:
        per_dir = {}
        for root in dict.fromkeys(order):
            xs = [r[scheme] for r, o in zip(rates, order) if o == root]
            q = statistics.quantiles(xs, n=4) if len(xs) > 1 else xs * 3
            per_dir[root] = {"runs": xs, "median": statistics.median(xs),
                             "q1": q[0], "q3": q[2]}
        wins = {root: 0 for root in per_dir}
        for i in range(0, len(order) - 1, 2):
            a, b = rates[i][scheme], rates[i + 1][scheme]
            if order[i] != order[i + 1] and a != b:
                wins[order[i] if a > b else order[i + 1]] += 1
        rec = {"ingest_tokens_per_s": per_dir, "pair_wins": wins}
        print(f"summary {scheme}: {json.dumps(rec)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
