#!/usr/bin/env python3
"""Trace the port's main path on one NVIDIA GPU with ``torch.profiler``.

    python3 chip_trace.py [--seed N]

Runs ``chip_smoke.py``'s MDB-L case (``TfIdfPipeline`` over ``FlashStore``
at 2**24 slots on the same seeded 2**25-token documents) and traces its
two windows, ingest (every document, then ``finalize``) and one lookup of
2**16 keys. For each window it prints one JSON line: the wall time, the
summed device time of every item on the card (kernels, copies, fills),
the share of the window the card sat idle, and the ten items that took
the most device time. The profiler's own host cost is inside the
windows, so the idle shares are upper bounds for an untraced run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import chip_smoke as S


def traced(fn, dev):
    """``fn()`` under ``torch.profiler``: its result and the window's
    wall time, device time, idle share and top device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    per = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            n, us = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in per.values()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:10]
    return out, {"wall_s": wall, "device_s": busy,
                 "idle_share": (1 - busy / wall) if busy else None,
                 "top": [[name[:60], n, us / 1e3] for name, (n, us) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_trace.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(S.SRC))
    from repro_torch.core.tfidf import TfIdfPipeline

    dev = torch.device("cuda", 0)
    print(f"card: {S.card_line()}", flush=True)
    docs = S.make_docs(S.FULL["tokens"], args.seed)
    cfg = {k: v for k, v in S.FULL.items() if k != "tokens"}
    pipe = TfIdfPipeline(scheme="MDB-L", device=dev, chunk=S.CHUNK, **cfg)

    def ingest():
        for doc in docs:
            pipe.add_document_ids(doc)
        pipe.finalize()

    _, rec = traced(ingest, dev)
    print(f"trace MDB-L ingest: {json.dumps(rec)}", flush=True)
    rng = np.random.default_rng(args.seed + 7)
    uniq = np.unique(np.concatenate(docs))
    half = S.N_QUERIES // 2
    keys = np.concatenate([rng.choice(uniq, half, replace=False),
                           rng.integers(1 << 30, 1 << 31, half)])
    _, rec = traced(lambda: pipe.term_table.query_batch(keys), dev)
    print(f"trace MDB-L lookup: {json.dumps(rec)}", flush=True)
    stats = pipe.term_table.stats()
    print("trace MDB-L counters: " + json.dumps(
        {k: stats[k] for k in ("write_overlap_us", "write_stall_us",
                               "write_dispatches", "query_tile_loads",
                               "query_filter_negatives")}), flush=True)
    pipe.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
