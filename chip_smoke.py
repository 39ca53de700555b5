#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card and ``nvcc``, and
fails (non-zero exit, no result line) without them. Phases:

1. the card's name and power limit, and the build of the CUDA kernels
   from ``src/repro_torch/kernels/flash_hash/csrc`` (timed);
2. every kernel held against its plain PyTorch version on the card at the
   main path's shapes (exact equality), with CUDA-event times;
3. the main path end to end: ``TfIdfPipeline`` over ``FlashStore`` with
   MDB-L at the paper's table size (2**24 slots in blocks of 1024, a
   2**21-entry change segment) on a seeded 2**25-token stream of
   documents, then MB and MDB at 2**20 slots on 2**21 tokens. Each run's
   answers for 2**16
   keys (half present, half absent) must equal ``np.unique`` counts of
   its stream, document frequencies included, with nothing dropped; the
   kernels' launch counters are zeroed before each run and must all be
   above 0 after it;
4. a ``kernels`` JSON line, then the card line, then the result line.

Any mismatch or failed phase raises, so the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU = "src/repro_torch/kernels/flash_hash/csrc/flash_hash.cu"
TPU = "src/repro/kernels/flash_hash/kernel.py"
REPLACES = {"merge_dirty": f"{TPU}:171", "query_grid": f"{TPU}:263",
            "filter_probe_grid": f"{TPU}:343"}

FULL = dict(q_log2=24, r_log2=10, log_capacity=1 << 21,
            max_updates_per_block=512, tokens=1 << 25)
SMALL = dict(q_log2=20, r_log2=10, log_capacity=1 << 17,
             max_updates_per_block=512, tokens=1 << 21)
DOC_LEN = 1 << 14
N_QUERIES = 1 << 16
CHUNK = 1 << 16


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_docs(n: int, seed: int, doc_len: int = DOC_LEN):
    """Documents of ``n`` tokens in all: each a ``SyntheticCorpus``
    document (Zipf(1.35) folded into 2**22 ids, the wiki corpus draw of
    the benchmarks; ``doc_len * 3/4`` tokens on average) with a third as
    many ids uniform over [0, 2**30) shuffled in, so a quarter of the
    stream is uniform. The last document is cut to make ``n``."""
    import numpy as np
    from repro_torch.data import SyntheticCorpus
    corpus = SyntheticCorpus(num_docs=2 * n // doc_len + 1,
                             mean_doc_len=doc_len - doc_len // 4,
                             vocab_size=1 << 22, zipf_a=1.35, seed=seed)
    rng = np.random.default_rng(seed)
    docs, total = [], 0
    for z in corpus.token_stream():
        u = rng.integers(0, 1 << 30, size=z.size // 3)
        docs.append(rng.permutation(np.concatenate([z, u]))[:n - total])
        total += docs[-1].size
        if total == n:
            return docs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(seed: int, dev, q_log2: int = 24, r_log2: int = 10,
                 max_u: int = 512, qcap: int = 128, n_rows: int = 1024):
    from repro_torch.core.hashing import Pow2Hash
    from repro_torch.kernels.flash_hash import check as C
    pair = Pow2Hash(q_log2, r_log2)
    n_b = pair.num_slots
    table = C.fill_table(pair, 0.55, seed, dev)
    res = {}
    for name, n_d, ident in (("merge_dirty", n_b, False),
                             ("merge_dirty_partial", n_b // 4, False),
                             ("merge", n_b, True)):
        blocks, uk, uc = C.merge_case(pair, table[0], n_d, max_u, 128,
                                      min(64, n_d), seed + 1, ident)
        res[name] = C.check_merge_dirty(pair, table, blocks, uk, uc,
                                        identity=ident)
        if res[name]["spills"] == 0:
            fail(f"{name}: no hot row spilled")
    n_rows = min(n_rows, n_b)
    blocks, q2 = C.query_layout(pair, table[0], n_rows, qcap, seed + 2)
    res["query_grid"] = C.check_query_grid(pair, table, blocks, q2)
    res["query"] = C.check_query(pair, table, q2.reshape(-1), qcap)
    res["filter_probe_grid"] = C.check_filter_probe_grid(table, blocks, q2)
    for name, r in res.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
        if r["max_abs_err"] != 0:
            fail(f"{name} disagrees with its plain version")
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def main_path(scheme: str, geo: dict, seed: int, dev, chunk: int = CHUNK,
              doc_len: int = DOC_LEN, n_queries: int = N_QUERIES):
    """One TF-IDF run, checked against the stream; returns its record
    (launch counts, ingest tokens/s, lookup keys/s, term-table wear).
    CPU tensors (rehearsals) run the plain versions and launch nothing."""
    import numpy as np
    import torch
    from repro_torch.core.tfidf import TfIdfPipeline
    from repro_torch.kernels.flash_hash import kernel as K

    docs = make_docs(geo["tokens"], seed, doc_len)
    stream = np.concatenate(docs)
    cfg = {k: v for k, v in geo.items() if k != "tokens"}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    pipe = TfIdfPipeline(scheme=scheme, device=dev, chunk=chunk, **cfg)
    t0 = time.perf_counter()
    for doc in docs:
        pipe.add_document_ids(doc)
    pipe.finalize()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ingest = time.perf_counter() - t0

    rng = np.random.default_rng(seed + 7)
    uniq, cnt = np.unique(stream, return_counts=True)
    half = n_queries // 2
    pick = rng.choice(uniq.size, half, replace=False)
    keys = np.concatenate([uniq[pick],
                           rng.integers(1 << 30, 1 << 31, n_queries - half)])
    t0 = time.perf_counter()
    got = pipe.term_table.query_batch(keys)
    t_query = time.perf_counter() - t0
    want = np.concatenate([cnt[pick], np.zeros(n_queries - half, np.int64)])
    if not np.array_equal(got, want):
        fail(f"{scheme}: {int((got != want).sum())} term counts differ "
             "from np.unique counts of the stream")
    du, dc = np.unique(np.concatenate([np.unique(d) for d in docs]),
                       return_counts=True)
    df = np.zeros(n_queries, np.int64)
    df[:half] = dc[np.searchsorted(du, uniq[pick])]
    if not np.array_equal(pipe.doc_table.query_batch(keys), df):
        fail(f"{scheme}: document frequencies differ from the stream's")
    launches = dict(K.LAUNCHES)
    stats = pipe.term_table.stats()
    wear = pipe.term_table.wear()
    for tbl in (pipe.term_table, pipe.doc_table):
        if tbl.wear()["dropped"] != 0:
            fail(f"{scheme}: entries dropped: {tbl.wear()}")
    if stats["query_filter_negatives"] <= 0:
        fail(f"{scheme}: the Bloom pre-filter answered no absent key")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"{scheme}: a kernel never launched on the main path: "
             f"{launches}")
    load = float((pipe.term_table.state.keys != -1).float().mean())
    pipe.close()
    out = {"scheme": scheme, "q_log2": geo["q_log2"],
           "tokens": int(stream.size), "documents": len(docs),
           "distinct": int(uniq.size),
           "load_factor": load, "ingest_s": t_ingest,
           "ingest_tokens_per_s": stream.size / t_ingest,
           "lookup_keys": n_queries, "lookup_s": t_query,
           "lookup_keys_per_s": n_queries / t_query, "launches": launches,
           "wear": wear,
           "query_filter_negatives": stats["query_filter_negatives"],
           "query_tile_loads": stats["query_tile_loads"],
           "write_overlap_us": stats["write_overlap_us"],
           "write_stall_us": stats["write_stall_us"],
           "write_dispatches": stats["write_dispatches"]}
    print(f"main path {scheme}: {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_hash import build
    from repro_torch.kernels.flash_hash import kernel as K

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    build.load()
    print(f"build: {build.last_build['seconds']:.1f} s -> "
          f"{build.last_build['path']}", flush=True)
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")

    res = kernel_phase(args.seed, dev)
    runs = [main_path("MDB-L", FULL, args.seed, dev)]
    for scheme in ("MB", "MDB"):
        runs.append(main_path(scheme, SMALL, args.seed + 1, dev))
    main_run = runs[0]
    for r in runs:
        print(f"wear {r['scheme']}: {json.dumps(r['wear'])}")
        print(f"ingest {r['scheme']}: {r['ingest_tokens_per_s']:.0f} tokens/s;"
              f" lookup: {r['lookup_keys_per_s']:.0f} keys/s")
    kernels = []
    for name in K.LAUNCHES:
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CU,
            "replaces": REPLACES[name],
            "launches": main_run["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
