#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card and ``nvcc``, and
fails (non-zero exit, no result line) without them. Phases:

1. the card's name and power limit, and the build of the CUDA kernels
   from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source, all
   started together; timed), with each kernel's registers and spills
   (``ptxas``) and its static count of HGMMA, UTMALDG, UBLKCP, SYNCS and
   LDG instructions (``cuobjdump -sass``);
2. every flash-hash kernel held against its plain PyTorch version on the
   card at the main path's shapes (exact equality, every lane). The merge
   runs five cases over 2**24 slots in blocks of 1024, at most 512
   updates a row: 16,384 listed blocks with 64 hot rows
   (``merge_dirty``), a quarter of the blocks (``_partial``), no hot row
   (``_cold``), every tile full so that every new key spills (``_full``)
   and the identity list (``merge``). The lookup kernels run at two
   layouts of 10 calls each: dense rows (1,024 disjoint blocks x 128
   live lanes) and the path's own dispatches (``check.path_query_layout``:
   1,024 keys bucketed by the path's code, a key or two per row). Each
   kernel the path's kernels replaced (the serial merge, the staged
   query) is held to the plain version too. Times
   (``check.py``'s docstring): each kernel's device time from CUDA-graph
   replays (``device_ms``; the query kernels cold, with the L2 flushed
   before every launch, and warm), the same for the replaced kernel, and
   for the filter probe the floor of a plain copy of its lanes; its raw
   launches from Python (``ms``) and its wrapper (checks and host sync
   included) in turns of 10 calls between two events; the plain version
   over single calls. The query kernels' cold device times at the path's
   layout are taken again from a ``torch.profiler`` trace (a cross
   check). The two flash-attention kernels against their plain version at
   llama3.2-3b's attention shapes (b=1, h=24, kvh=8, d=dv=128): bf16
   causal at s=512 (the serve phase's prefill), 4096 and a ragged 1000,
   non-causal and with q and k scaled x8 at 512 (the tensor-core kernel,
   and the CUDA-core kernel at the same shapes), f32 at 512 and at the
   tiny twin's prefill (the CUDA-core kernel), within 2e-2 (bf16) / 2e-5
   (f32) with TF32 off, with CUDA-event medians timed in turns: the
   kernel, the CUDA-core kernel (bf16 cases), one
   ``scaled_dot_product_attention`` call (timed only, never on the path)
   and the plain version, and the first three's device times;
3. the TF-IDF path end to end: ``TfIdfPipeline`` over ``FlashStore`` with
   MDB-L at the paper's table size (2**24 slots in blocks of 1024, a
   2**21-entry change segment) on a seeded 2**25-token stream of
   documents, then MB and MDB at 2**20 slots on 2**21 tokens. Each run's
   answers for 2**16
   keys (half present, half absent) must equal ``np.unique`` counts of
   its stream, document frequencies included, with nothing dropped; the
   kernels' launch counters are zeroed before each run and must all be
   above 0 after it;
4. durability at the paper's table size: a child process (this script
   under ``--durability-child``, reusing the kernels built above) opens
   a ``FlashStore`` (MDB-L, 2**24 slots) with a write-ahead log, ingests
   batches 1-8 of the 2**25-token stream in 16 batches (one drain each),
   snapshots after batch 4 and is SIGKILLed by its own WAL hook at the
   seal of batch 8. The parent restores a fresh store on the card from
   the snapshot and the log (4 records replayed, nothing discarded),
   checks every distinct key of batches 1-8 and as many absent keys
   against ``np.unique`` counts, ingests batches 9-16, flushes and checks
   every key of the stream again (with 2**15 absent keys, as the main
   path's lookup has), with nothing dropped; the merge, query
   and Bloom kernels must each launch after the restore. It prints the
   snapshot's seconds and bytes, the log's bytes, the restore's seconds
   and replayed entries per second, and the launch counts;
5. the sim against the card: ``TfIdfPipeline`` on the event-level
   simulator (host) and on the card, for MB, MDB and MDB-L, on the same
   2**15 seeded tokens: identical term counts, document frequencies and
   IDF; the sim's ``cleans`` (the paper's erase count) beside the card's
   ``tile_stores``;
6. the sharded store (``FlashStore(backend="sharded")``) in one process:
   MDB-L's table split over 4 shards on the one card (each 2**22 slots
   with a 2**19-entry log, so 2**24 slots and a 2**21-entry change
   segment in all; waves of 65,536 entries a shard, a shard's H_R
   draining at 131,072) on MDB-L's 2**25-token stream: every distinct
   key and as many absent against ``np.unique``, the single-table run's
   answers on its keys, nothing carried or dropped, all three hash
   kernels launched; ingest and lookup rates beside the single table's,
   drains, waves, tile stores overall and per shard, the placement;
7. the sharded store over two processes: two ranks of a gloo group (this
   script under ``--sharded-child``, reusing the kernels built above),
   both on the card with two shards each (2**20 slots in all), on the MB
   / MDB runs' 2**21-token stream, each rank folding alternate documents
   and both draining after every 8; both ranks' answers equal
   ``np.unique``'s and a single-process run's, each rank carried nothing
   and launched all three hash kernels; a failed or hung rank fails the
   phase;
8. a small ±Δ stream through a 4-shard store on the card and on the CPU,
   MB, MDB and MDB-L: identical global state arrays and answers;
9. the serving path at full width: llama3.2-3b (28 layers, bf16, weights
   drawn from ``--seed`` on the card) behind ``ServeEngine`` with a
   ``PrefixKVCache(block_tokens=8, capacity_blocks=64)`` whose refcounts
   live in the port's device ``FlashStore``. Eight requests of 512-token
   prompts and 32 new tokens: request 0 fills the pool, requests 1-3
   share its first 256 tokens (prefix hits, the rest decoded token by
   token), requests 4-7 are fresh and evict. Outputs, cached prefixes,
   hits, misses, evictions, refcounts after release and 5 x 28
   launches of the tensor-core flash-attention kernel (and none of the
   CUDA-core one) are checked;
10. continuous batching at the same width on the same model:
   ``ContinuousBatchingScheduler`` (4 packed slots, 496 rows of context,
   one 16-token prefill chunk a tick) over a ``PrefixKVCache(block_tokens=
   16, capacity_blocks=128)`` on the card, replaying a seeded 16-request
   trace (8 Zipf(1.2) users, each with a 256-token system prefix, plus
   64-192 tokens of the request's own, 32 new tokens) through two feeder
   threads. Every request's 32 ids, finite logits, cached prefixes
   (block multiples, at most the prefix), hits and evictions above 0,
   nothing dropped, every refcount 0 after the run. It prints ticks,
   chunk calls, decode steps, median chunk and packed-decode ms (a sync
   around each), wall time, tokens/s, latencies, hit rate, wear, the
   hash kernels' launches and the phase's peak memory, beside the serial
   phase's tokens/s;
11. the same request order scaled down on llama32 TINY in f32, served on
   the card and on the CPU with the same weights: outputs, cached
   prefixes and cache stats must be identical. The serial engine's pins
   cancel in the store's write buffer, so the twin runs again with a
   flush threshold of 1 (every pin and unpin drained into the device
   table), reading each request's refcounts while it holds its pins: the
   refcounts read back from the table must agree too, and every
   flash-hash kernel must have launched on the card; every prefill of
   the f32 twin runs the CUDA-core flash-attention kernel (and none the
   tensor-core one);
12. the continuous run scaled down on the same TINY twin (3 slots, a
   16-block pool, an 8-request trace of 3 users), on the card and on the
   CPU, then again with a flush threshold of 1: outputs, cached prefixes,
   cache stats and refcounts identical on both, and outputs identical to
   the serial engine's on the CPU; in the drained run every flash-hash
   kernel must have launched on the card;
13. a ``kernels`` JSON line, then the card line, then the result line.

Any mismatch or failed phase raises, so the script exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU = "src/repro_torch/kernels/flash_hash/csrc/flash_hash.cu"
FA_CU = "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu"
TPU = "src/repro/kernels/flash_hash/kernel.py"
REPLACES = {"merge_dirty": f"{TPU}:172", "query_grid": f"{TPU}:264",
            "filter_probe_grid": f"{TPU}:344",
            "flash_attention": "src/repro/kernels/flash_attn/kernel.py:72"}

FULL = dict(q_log2=24, r_log2=10, log_capacity=1 << 21,
            max_updates_per_block=512, tokens=1 << 25)
SMALL = dict(q_log2=20, r_log2=10, log_capacity=1 << 17,
             max_updates_per_block=512, tokens=1 << 21)
DOC_LEN = 1 << 14
N_QUERIES = 1 << 16
CHUNK = 1 << 16

#: attention heads (h, kvh, d, dv) of llama3.2-3b and of its TINY twin
LLAMA_HEADS = (24, 8, 128, 128)
TINY_HEADS = (4, 2, 16, 16)
#: flash attention cases: (name, s, dtype, causal, heads, q/k scale); the
#: tiny twin's prefill is its 40-token prompt
ATTN_CASES = [("serve", 512, "bfloat16", True, LLAMA_HEADS, 1.0),
              ("long", 4096, "bfloat16", True, LLAMA_HEADS, 1.0),
              ("ragged", 1000, "bfloat16", True, LLAMA_HEADS, 1.0),
              ("f32", 512, "float32", True, LLAMA_HEADS, 1.0),
              ("non_causal", 512, "bfloat16", False, LLAMA_HEADS, 1.0),
              ("qk_x8", 512, "bfloat16", True, LLAMA_HEADS, 8.0),
              ("tiny_f32", 40, "float32", True, TINY_HEADS, 1.0)]
#: the serve phase's traffic (full width) and its scaled-down twin (TINY)
SERVE = dict(prompt_len=512, shared=256, max_new=32, block_tokens=8,
             capacity_blocks=64)
TINY_SERVE = dict(prompt_len=40, shared=16, max_new=16, block_tokens=8,
                  capacity_blocks=5)
#: the twin again with every pin and unpin drained into the device table
#: (the serial engine's pins otherwise cancel in H_R), each request's
#: refcounts read back while it holds them
TINY_DRAINED = dict(TINY_SERVE, flush_threshold=1, read_pins=True)
#: prefix-cache counters that depend on when an asynchronous drain lands
TIMING_STATS = ("query_cache_hits", "query_device_keys", "query_batches")
#: the continuous-batching run at full width: four packed slots over
#: 16-token blocks, the trace's 256-token system prefix of eight users
#: plus 64-192 tokens of each request's own. A request pins at most 28
#: blocks, so four slots pin at most 112 of the pool's 128: no eviction
#: ever has to take a pinned block. About 200 distinct whole blocks: it
#: evicts.
CONTINUOUS = dict(max_slots=4, max_context=496, capacity_blocks=128,
                  trace=dict(num_requests=16, num_users=8, zipf_s=1.2,
                             prefix_blocks=16, block_tokens=16,
                             suffix_tokens=(64, 192), max_new_tokens=32))
#: its scaled-down twin (TINY, f32, card and CPU), then again with every
#: pin and unpin drained into the device table; at most 3 x 4 of the 16
#: blocks pinned
TINY_CONTINUOUS = dict(max_slots=3, max_context=96, capacity_blocks=16,
                       trace=dict(num_requests=8, num_users=3,
                                  prefix_blocks=2, block_tokens=16,
                                  suffix_tokens=(16, 40), max_new_tokens=8))
TINY_CONTINUOUS_DRAINED = dict(TINY_CONTINUOUS, flush_threshold=1)
#: the durability run: FULL's stream in 16 batches, a snapshot after
#: batch 4, the child killed at the seal of batch 8
DURABILITY = dict(batches=16, snap_at=4, kill_at=8)
SURVIVED = "DURABILITY_CHILD_SURVIVED"
#: the sim-vs-card run: 2**15 tokens in documents of 1,024; the sim's
#: table of 65,536 entries (64 blocks of 16 pages of 64), the card's of
#: 2**16 slots
SIM_TOKENS = 1 << 15
SIM_DOC_LEN = 1 << 10
SIM_GEOM = dict(num_blocks=64, pages_per_block=16, entries_per_page=64)
SIM_CARD = dict(q_log2=16, r_log2=10, log_capacity=1 << 13,
                max_updates_per_block=512)
#: the sharded MDB-L run: MDB-L's table split over 4 shards on one card
#: (each 2**22 slots, a 2**19-entry log: 2**24 slots and a 2**21-entry
#: change segment in all) on MDB-L's stream; waves of 65,536 entries a
#: shard, a shard's H_R drains at 131,072
SHARDED = dict(q_log2=22, r_log2=10, log_capacity=1 << 19,
               max_updates_per_block=512, tokens=1 << 25, num_shards=4,
               shard_chunk=1 << 16, flush_threshold=1 << 17)
#: the two-rank run: 4 shards of 2**18 slots (2**20 in all) over two
#: processes on the card, on the MB / MDB runs' stream; each rank folds
#: alternate documents, both drain after every 8
TWO_RANK = dict(q_log2=18, r_log2=10, log_capacity=1 << 15,
                max_updates_per_block=512, tokens=1 << 21, num_shards=4,
                shard_chunk=1 << 12)
TWO_RANK_PER_DRAIN = 8
TWO_RANK_TIMEOUT = 300           # seconds a rank may take
#: the sharded card-vs-CPU twin: 4 shards of 8 blocks of 128 slots
TINY_SHARDED = dict(q_log2=10, r_log2=7, log_capacity=1 << 11,
                    max_updates_per_block=128, num_shards=4,
                    shard_chunk=256)


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


def kernel_name(mangled: str) -> str:
    """``flash_attn_wgmma_kernel<128,2>`` from a mangled kernel name: the
    first length-prefixed identifier ending in ``_kernel`` and its
    template arguments (integers, bools and types)."""
    import re
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            i += 1
            continue
        j = i + len(m.group())
        ident = mangled[j:j + int(m.group())]
        i = j + len(ident)
        if ident.endswith("_kernel"):
            rest = mangled[i:]
            if not rest.startswith("I"):
                return ident
            args = re.findall(r"Li(\d+)E|^I(f)|13(__nv_bfloat16)|Lb([01])E",
                              rest[:rest.find("EE") + 1])
            args = [{"f": "float", "b0": "false", "b1": "true"}.get(
                "".join(a[:3]) or "b" + a[3], "".join(a)) for a in args]
            return f"{ident}<{','.join(args)}>"
    return mangled


def kernel_report(lib) -> dict:
    """Each kernel of a built library: its static SASS counts of HGMMA,
    UTMALDG, UBLKCP, SYNCS and LDG and its registers and spills from
    ``ptxas``. Fails if an instance of the tensor-core attention kernel has
    no HGMMA, or one of the merge kernel no bulk copy."""
    from repro_torch.kernels import nvcc
    ptxas = nvcc.ptxas_report(lib.last_build["log"])
    out = {}
    for mangled, counts in nvcc.sass_counts(Path(lib.last_build["path"]))\
            .items():
        name = kernel_name(mangled)
        out[name] = {**counts, **ptxas.get(mangled, {})}
        if "wgmma" in name and counts["HGMMA"] == 0:
            fail(f"{name}: no HGMMA instruction in its SASS")
        if name.startswith("merge_dirty_kernel") and counts["UBLKCP"] == 0:
            fail(f"{name}: no bulk copy (UBLKCP) in its SASS")
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(seed: int, dev, q_log2: int = 24, r_log2: int = 10,
                 max_u: int = 512, qcap: int = 128, n_rows: int = 1024,
                 reps: int = 30):
    from repro_torch.core.hashing import Pow2Hash
    from repro_torch.kernels.flash_hash import check as C
    pair = Pow2Hash(q_log2, r_log2)
    n_b = pair.num_slots
    table = C.fill_table(pair, 0.55, seed, dev)
    full = C.full_table(pair, seed + 3, dev)
    res = {}
    for name, tbl, n_d, hot, ident in (
            ("merge_dirty", table, n_b, 64, False),
            ("merge_dirty_partial", table, n_b // 4, 64, False),
            ("merge_dirty_cold", table, n_b, 0, False),
            ("merge_dirty_full", full, n_b, 64, False),
            ("merge", table, n_b, 64, True)):
        blocks, uk, uc = C.merge_case(pair, tbl[0], n_d, max_u, 128,
                                      min(hot, n_d), seed + 1, ident)
        r = res[name] = C.check_merge_dirty(pair, tbl, blocks, uk, uc,
                                            identity=ident)
        if hot and r["spills"] == 0:
            fail(f"{name}: no hot row spilled")
    del full
    # the lookup kernels at two layouts, each call of a turn on its own:
    # dense rows over disjoint blocks, and the path's dispatches
    n_rows = min(n_rows, n_b)
    turn = range(C.CALLS_PER_TURN)
    dense = [C.query_layout(pair, table[0], n_rows, qcap, seed + 2, part=i)
             for i in turn]
    path = [path_layout(pair, table, seed + 2 + i, n_rows, qcap)
            for i in turn]
    probed = [p[0] for p in path]
    queried = [p[1] for p in path]
    res["query_grid"] = C.check_query_grid(pair, table, *dense[0], reps,
                                           rotation=dense[1:])
    res["query_grid_path"] = C.check_query_grid(pair, table, *queried[0],
                                                reps, rotation=queried[1:])
    res["query"] = C.check_query(pair, table, dense[0][1].reshape(-1), qcap,
                                 reps)
    res["filter_probe_grid"] = C.check_filter_probe_grid(
        table, *dense[0], reps, rotation=dense[1:])
    res["filter_probe_grid_path"] = C.check_filter_probe_grid(
        table, *probed[0], reps, rotation=probed[1:])
    for name, r in res.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
        for who in ("", "serial_", "staged_"):
            if r.get(who + "max_abs_err", 0) != 0:
                fail(f"{name} ({who or 'kernel'}) disagrees with its plain "
                     f"version")
        times = "; ".join(
            f"{k} {v:.5g} ms ({r[k[:-2] + 'bound_share']:.1%} of the bound)"
            for k, v in r.items() if k.endswith("ms") and k not in (
                "bound_ms", "plain_ms") and v)
        print(f"{name}: {times}; plain {r['plain_ms']:.5g} ms; bound "
              f"{r['bound_ms']:.5g} ms ({r['bound_by']})", flush=True)
    if dev.type == "cuda":
        res["cross_check"] = cross_check(pair, table, queried, dev, reps)
    return res


def path_layout(pair, table, seed: int, n_keys: int, qcap: int):
    """The ``(blocks, q2)`` of the Bloom probe and of the query for one
    lookup dispatch: the smoke's mix (``check.lookup_mix``) through the
    query engine's Bloom pre-filter, its first chunk of ``n_keys``, and
    ``ops.query_blocked_ex``'s layout (``check.path_query_layout``)."""
    from repro_torch.core import segments as seg
    from repro_torch.kernels.flash_hash import check as C
    mix = C.lookup_mix(table[0], seed, n_keys)
    chunk = C.padded(mix[seg.filter_may_contain(pair, table[2], mix)],
                     n_keys)
    return C.path_query_layout(pair, table[2], chunk, qcap)


def cross_check(pair, table, layouts, dev, reps: int) -> dict:
    """Both query kernels' cold device times at the path's layouts two
    ways: graph replays timed by events (``check.device_ms``) and the
    kernels' own durations in a ``torch.profiler`` trace
    (``check.profiled_ms``)."""
    import torch
    from repro_torch.kernels.flash_hash import check as C
    from repro_torch.kernels.flash_hash import kernel as K
    keys, counts, _ = table
    outs = [(torch.empty_like(q), torch.empty_like(q)) for _, q in layouts]
    fns = {v: (lambda i, v=v: K._launch_query_grid(
        pair, keys, counts, *layouts[i], *outs[i], v))
        for v in K.QUERY_ENTRIES}
    names = {"probe": "query_grid_kernel<", "staged": "query_grid_staged"}
    out = C._counted(lambda: {
        "graph_ms": C.device_ms(fns, reps, dev, C.L2_FLUSH_BYTES),
        "profiler_ms": C.profiled_ms(fns, names, reps, dev,
                                     C.L2_FLUSH_BYTES)})
    print(f"cross check (query_grid, path layout, cold): {json.dumps(out)}",
          flush=True)
    return out


def zero_launches(*counters) -> None:
    for counts in counters:
        for k in counts:
            counts[k] = 0


def no_baseline(where: str) -> None:
    """Fail if a replaced kernel (the serial merge, the staged query)
    launched: no path may run one."""
    from repro_torch.kernels.flash_hash import kernel as K
    if any(K.BASELINE_LAUNCHES.values()):
        fail(f"{where}: a replaced kernel launched {K.BASELINE_LAUNCHES}")


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
    zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES)
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
    no_baseline(scheme)
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
    out["answers"] = (keys, got)
    return out


def attention_phase(seed: int, dev, cases=ATTN_CASES, reps: int = 30):
    """The flash-attention kernels against their plain version; each case
    must run the kernel the dtype/shape split names for it."""
    import torch
    from repro_torch.kernels.flash_attn import check as FC
    from repro_torch.kernels.flash_attn import kernel as FK
    res = {}
    for name, s, dtype, causal, (h, kvh, d, dv), qk_scale in cases:
        dt = getattr(torch, dtype)
        r = FC.check_flash_attention(1, s, h, kvh, d, dv, dt, causal,
                                     seed + s, dev, reps=reps,
                                     qk_scale=qk_scale)
        print(f"kernel flash_attention {name}: {json.dumps(r)}", flush=True)
        want = FK.kernel_for(dt, d, dv) if dev.type == "cuda" else "plain"
        if r["kernel"] != want:
            fail(f"flash_attention {name} ran {r['kernel']}, not {want}")
        for who in ("", "simt_"):
            if who + "max_abs_err" in r and not (
                    r[who + "finite"] and r[who + "within_tolerance"]):
                fail(f"flash_attention {name} ({who or r['kernel']}) "
                     f"disagrees with its plain version (max abs err "
                     f"{r[who + 'max_abs_err']}, tolerance "
                     f"{r['tolerance']})")
        shares = "; ".join(
            f"{k} {r[k]:.5g} ms ({r[k[:-2] + 'bound_share']:.1%} of the "
            f"bound)" for k in ("device_ms", "ms", "simt_device_ms",
                                "simt_ms", "library_device_ms", "library_ms",
                                "plain_ms") if r.get(k))
        print(f"flash_attention {name} ({r['kernel']}): {shares}; bound "
              f"{r['bound_ms']:.5g} ms ({r['bound_by']})", flush=True)
        res[name] = r
    return res


# ---------------------------------------------------------------------------
# phase 4: durability (snapshot, WAL, SIGKILL, restore) at the paper's size
# ---------------------------------------------------------------------------
def durability_batches(plan: dict):
    """The plan's stream (``make_docs``) cut into its batches."""
    import numpy as np
    docs = make_docs(plan["geo"]["tokens"], plan["seed"], plan["doc_len"])
    return np.array_split(np.concatenate(docs), plan["batches"])


def durability_store(plan: dict, dev, wal: Path):
    """The durability run's store: MDB-L at the plan's geometry on
    ``dev``, with the WAL; the flush threshold is above a batch, so only
    the explicit per-batch drains seal. Its lookups are checks of
    millions of distinct keys, so it keeps no hot-key cache."""
    from repro_torch.core.store import FlashStore
    geo = {k: v for k, v in plan["geo"].items() if k != "tokens"}
    batch = -(-plan["geo"]["tokens"] // plan["batches"])
    return FlashStore.open(scheme="MDB-L", device=dev, wal=wal,
                           chunk=plan["chunk"], query_chunk=plan["chunk"],
                           flush_threshold=batch + 1, hot_capacity=0, **geo)


def child_command(workdir: Path, seed: int):
    """How the parent starts the durability child: this script again."""
    return [sys.executable, str(Path(__file__).resolve()), "--seed",
            str(seed), "--durability-child", str(workdir)]


def durability_child(workdir: Path, dev) -> None:
    """Ingest batches 1..kill_at (a drain after each, a snapshot after
    snap_at); the WAL hook SIGKILLs this process at the seal of batch
    kill_at, after its record is durable and before its drain runs."""
    import torch
    plan = json.loads((workdir / "plan.json").read_text())
    batches = durability_batches(plan)
    store = durability_store(plan, dev, workdir / "wal")

    def kill(seal_events: int) -> None:
        if seal_events == plan["kill_at"]:
            os.kill(os.getpid(), signal.SIGKILL)   # no cleanup, no flush

    store.wal.after_sync = kill
    for i, batch in enumerate(batches[:plan["kill_at"]], start=1):
        store.update(batch)
        store.drain(wait=False)
        if i == plan["snap_at"]:
            t0 = time.perf_counter()
            snap = store.snapshot(workdir / "snap")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            rec = {"snapshot_s": time.perf_counter() - t0,
                   "snapshot_bytes": sum(f.stat().st_size
                                         for f in snap.iterdir()),
                   "snapshot_dir": snap.name, "after_batch": i}
            print(f"durability child: {json.dumps(rec)}", flush=True)
    print(SURVIVED, flush=True)


def check_counts(store, batches, seed: int, what: str,
                 n_absent=None) -> dict:
    """Every distinct key of ``batches`` and ``n_absent`` absent ones (as
    many as the distinct ones by default; ids at or above 2**30, which
    ``make_docs`` never draws) against ``np.unique`` counts; returns the
    lookup's size and time."""
    import numpy as np
    uniq, cnt = np.unique(np.concatenate(batches), return_counts=True)
    n_absent = uniq.size if n_absent is None else n_absent
    absent = np.random.default_rng(seed).integers(1 << 30, 1 << 31,
                                                  n_absent)
    keys = np.concatenate([uniq, absent])
    t0 = time.perf_counter()
    got = store.query_batch(keys)
    dt = time.perf_counter() - t0
    want = np.concatenate([cnt, np.zeros(n_absent, np.int64)])
    if not np.array_equal(got, want):
        fail(f"durability {what}: {int((got != want).sum())} of "
             f"{keys.size} counts differ from np.unique counts")
    return {"keys": int(keys.size), "distinct": int(uniq.size),
            "lookup_s": dt, "lookup_keys_per_s": keys.size / dt}


def durability_phase(seed: int, dev, geo: dict = FULL,
                     doc_len: int = DOC_LEN, chunk: int = CHUNK) -> dict:
    """Kill a child mid-stream, restore on ``dev``, check every count.
    On the card the restore's replay must merge (its 4 records overflow
    the 2**21-entry log), the first check must probe, and every kernel
    must have launched by the end of the phase."""
    import torch
    from repro_torch.kernels.flash_hash import kernel as K
    plan = {"geo": geo, "seed": seed, "doc_len": doc_len, "chunk": chunk,
            **DURABILITY}
    t_phase = time.perf_counter()
    workdir = Path(tempfile.mkdtemp(prefix="flash-durability-"))
    try:
        (workdir / "plan.json").write_text(json.dumps(plan))
        t0 = time.perf_counter()
        proc = subprocess.run(child_command(workdir, seed),
                              capture_output=True, text=True, timeout=900)
        t_child = time.perf_counter() - t0
        if proc.returncode != -signal.SIGKILL or SURVIVED in proc.stdout:
            fail(f"durability: the child was not killed by signal 9 at "
                 f"the seal of batch {plan['kill_at']} (rc "
                 f"{proc.returncode})\nstdout: {proc.stdout[-2000:]}\n"
                 f"stderr: {proc.stderr[-4000:]}")
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("durability child: ")]
        if len(lines) != 1:
            fail(f"durability: the child took no snapshot: {proc.stdout}")
        child = json.loads(lines[0].split(": ", 1)[1])
        wal_bytes = (workdir / "wal").stat().st_size
        batches = durability_batches(plan)
        kill_at = plan["kill_at"]

        zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES)
        store = durability_store(plan, dev, workdir / "wal")
        t0 = time.perf_counter()
        rep = store.restore(workdir / "snap")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_restore = time.perf_counter() - t0
        if (rep.snapshot_step is None
                or rep.records_replayed < kill_at - plan["snap_at"]
                or rep.tail_discarded_bytes != 0):
            fail(f"durability: restore report {rep}")
        if store.state.device != dev:
            fail(f"durability: restored onto {store.state.device}")
        at_restore = dict(K.LAUNCHES)
        first = check_counts(store, batches[:kill_at], seed + 11,
                             f"after batch {kill_at}")
        at_check = dict(K.LAUNCHES)
        for batch in batches[kill_at:]:
            store.update(batch)
            store.drain(wait=False)
        store.flush()
        full = check_counts(store, batches, seed + 12, "after the stream",
                            n_absent=N_QUERIES // 2)
        wear = store.wear()
        if wear["dropped"] != 0:
            fail(f"durability: entries dropped: {wear}")
        launches = dict(K.LAUNCHES)
        if dev.type == "cuda" and (
                at_restore["merge_dirty"] <= 0
                or min(at_check["query_grid"],
                       at_check["filter_probe_grid"]) <= 0
                or min(launches.values()) <= 0):
            fail(f"durability: a kernel did not launch where it must: "
                 f"in the restore's replay {at_restore}, by the end of "
                 f"the first check {at_check}, by the end of the phase "
                 f"{launches}")
        no_baseline("durability")
        store.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out = {"child_s": t_child, **child, "wal_bytes": wal_bytes,
           "restore_s": t_restore, "snapshot_step": rep.snapshot_step,
           "records_replayed": rep.records_replayed,
           "entries_replayed": rep.entries_replayed,
           "replayed_entries_per_s": rep.entries_replayed / t_restore,
           "tail_discarded_bytes": rep.tail_discarded_bytes,
           "check_after_kill": first, "check_after_stream": full,
           "launches_at_restore": at_restore,
           "launches_at_check": at_check, "launches": launches,
           "wear": wear, "phase_s": time.perf_counter() - t_phase}
    print(f"durability MDB-L: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: the event-level sim against the card
# ---------------------------------------------------------------------------
def sim_vs_card(seed: int, dev) -> dict:
    """TF-IDF on the sim and on ``dev`` from the same documents: term
    counts, document frequencies and IDF identical for every scheme."""
    import numpy as np
    from repro_torch.core.flash_model import TableGeometry
    from repro_torch.core.tfidf import TfIdfPipeline
    docs = make_docs(SIM_TOKENS, seed, SIM_DOC_LEN)
    uniq, cnt = np.unique(np.concatenate(docs), return_counts=True)
    keys = np.concatenate([uniq, np.random.default_rng(seed).integers(
        1 << 30, 1 << 31, 256)])
    out = {}
    for scheme in ("MB", "MDB", "MDB-L"):
        pipes = {"sim": TfIdfPipeline(scheme=scheme, backend="sim",
                                      geom=TableGeometry(**SIM_GEOM)),
                 "card": TfIdfPipeline(scheme=scheme, device=dev,
                                       chunk=4096, **SIM_CARD)}
        res = {}
        for name, pipe in pipes.items():
            for doc in docs:
                pipe.add_document_ids(doc)
            pipe.finalize()
            tf = pipe.term_table.query_batch(keys)
            df = pipe.doc_table.query_batch(keys)
            idf = np.zeros(keys.size)
            idf[df > 0] = np.log(pipe.num_docs / df[df > 0])
            res[name] = (tf, df, idf)
        want = np.concatenate([cnt, np.zeros(keys.size - uniq.size,
                                             np.int64)])
        if not np.array_equal(res["sim"][0], want):
            fail(f"sim {scheme}: term counts differ from np.unique's")
        for i, what in enumerate(("term counts", "document frequencies",
                                  "IDF")):
            if not np.array_equal(res["sim"][i], res["card"][i]):
                fail(f"sim vs card {scheme}: {what} differ")
        card_wear = pipes["card"].term_table.wear()
        if card_wear["dropped"] != 0:
            fail(f"sim vs card {scheme}: the card dropped entries")
        out[scheme] = {
            "tokens": SIM_TOKENS, "documents": len(docs),
            "distinct": int(uniq.size),
            "sim_cleans": pipes["sim"].term_table.wear()["cleans"],
            "card_tile_stores": card_wear["tile_stores"],
            "sim_doc_cleans": pipes["sim"].doc_table.wear()["cleans"],
            "card_doc_tile_stores":
                pipes["card"].doc_table.wear()["tile_stores"]}
        for pipe in pipes.values():
            pipe.close()
        print(f"sim vs card {scheme}: identical term counts, document "
              f"frequencies and IDF; {json.dumps(out[scheme])}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 6-8: the sharded store
# ---------------------------------------------------------------------------
def sharded_store(geo: dict, dev, scheme: str = "MDB-L"):
    """A sharded ``FlashStore`` at ``geo`` (each shard's table, the shard
    count, the wave size ``shard_chunk`` = ``bucket_cap``) on ``dev``: the
    whole store in one process, or this rank's shards when
    ``torch.distributed`` is initialised. No hot-key cache: its lookups
    are checks of millions of distinct keys."""
    from repro_torch.core import table_torch as tt
    from repro_torch.core.distributed import ShardedTableConfig
    from repro_torch.core.store import FlashStore
    table = {k: geo[k] for k in ("q_log2", "r_log2", "log_capacity",
                                 "max_updates_per_block")}
    cfg = ShardedTableConfig(local=tt.FlashTableConfig(scheme=scheme, **table),
                             num_shards=geo["num_shards"],
                             bucket_cap=geo["shard_chunk"])
    return FlashStore.open(cfg, backend="sharded", device=dev,
                           shard_chunk=geo["shard_chunk"],
                           flush_threshold=geo.get("flush_threshold"),
                           query_chunk=CHUNK, hot_capacity=0)


def distinct_and_absent(stream, seed: int):
    """Every distinct key of ``stream`` and as many absent ones (ids at or
    above 2**30, which ``make_docs`` never draws), with the expected
    counts."""
    import numpy as np
    uniq, cnt = np.unique(stream, return_counts=True)
    absent = np.random.default_rng(seed).integers(1 << 30, 1 << 31,
                                                  uniq.size)
    return (np.concatenate([uniq, absent]),
            np.concatenate([cnt, np.zeros(uniq.size, np.int64)]))


def shard_record(store) -> dict:
    """The sharded store's counters the phases print."""
    s = store.stats()
    return {"drains": s["write_flushes"], "waves": s["write_dispatches"],
            "auto_drains": s["write_auto_flushes"],
            "piggybacked": s["write_piggybacked"],
            "tile_stores": s["tile_stores"],
            "tile_stores_per_shard": [int(st.stats.tile_stores)
                                      for st in store.state],
            "merges": s["merges"], "stages": s["stages"],
            "dropped": s["dropped"], "write_carried": s["write_carried"],
            "query_tile_loads": s["query_tile_loads"],
            "query_filter_negatives": s["query_filter_negatives"],
            "collectives": s["collectives"], "placement": s["placement"]}


def sharded_phase(seed: int, dev, main_run: dict, geo: dict = SHARDED,
                  doc_len: int = DOC_LEN) -> dict:
    """The MDB-L run's stream through one process's sharded store
    (``geo``'s shards all on ``dev``): every distinct key and as many
    absent against ``np.unique``, the single-table run's answers on its
    own keys, nothing carried or dropped, and all three hash kernels
    launched on the card in this run."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_hash import kernel as K
    t_phase = time.perf_counter()
    docs = make_docs(geo["tokens"], seed, doc_len)
    zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES)
    store = sharded_store(geo, dev)
    t0 = time.perf_counter()
    for doc in docs:
        store.update(doc)
    store.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ingest = time.perf_counter() - t0
    keys, want = distinct_and_absent(np.concatenate(docs), seed + 13)
    t0 = time.perf_counter()
    got = store.query_batch(keys)
    t_query = time.perf_counter() - t0
    if not np.array_equal(got, want):
        fail(f"sharded MDB-L: {int((got != want).sum())} of {keys.size} "
             "counts differ from np.unique counts of the stream")
    one_keys, one_got = main_run["answers"]
    if not np.array_equal(store.query_batch(one_keys), one_got):
        fail("sharded MDB-L: answers differ from the single-table run's")
    launches = dict(K.LAUNCHES)
    rec = shard_record(store)
    store.close()
    if rec["dropped"] or rec["write_carried"]:
        fail(f"sharded MDB-L: dropped or carried entries: {rec}")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"sharded MDB-L: a kernel never launched: {launches}")
    no_baseline("sharded MDB-L")
    out = {"shards": geo["num_shards"], "local_q_log2": geo["q_log2"],
           "tokens": int(sum(d.size for d in docs)), "documents": len(docs),
           "distinct": int(keys.size // 2), "ingest_s": t_ingest,
           "ingest_tokens_per_s": geo["tokens"] / t_ingest,
           "lookup_keys": int(keys.size), "lookup_s": t_query,
           "lookup_keys_per_s": keys.size / t_query,
           "single_table_ingest_tokens_per_s":
               main_run["ingest_tokens_per_s"],
           "single_table_lookup_keys_per_s": main_run["lookup_keys_per_s"],
           **rec, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print(f"sharded MDB-L: {json.dumps(out)}", flush=True)
    return out


def two_rank_ingest(store, docs, rank: int, world: int, per_drain: int):
    """Documents in groups of ``per_drain``: each rank folds the documents
    whose index is its rank modulo ``world``, and every rank drains after
    every group (a collective drain with several processes)."""
    for g in range(0, len(docs), per_drain):
        for i in range(g, min(g + per_drain, len(docs))):
            if i % world == rank:
                store.update(docs[i])
        store.drain(wait=True)
    store.flush()


def sharded_child_command(workdir: Path, seed: int, rank: int):
    """How the parent starts a rank of the two-rank phase: this script."""
    return [sys.executable, str(Path(__file__).resolve()), "--seed",
            str(seed), "--sharded-child", str(workdir), "--rank", str(rank)]


def sharded_child(workdir: Path, rank: int, dev) -> None:
    """One rank of the two-rank phase: join the gloo group, ingest its
    documents, drain with the other rank after every group, flush, query
    the plan's keys (the same on both ranks) and write its answers, its
    counters and its kernels' launches to ``workdir``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_hash import kernel as K
    plan = json.loads((workdir / "plan.json").read_text())
    geo = plan["geo"]
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{plan['port']}",
        world_size=plan["world"], rank=rank,
        timeout=datetime.timedelta(seconds=plan["timeout"]))
    try:
        docs = make_docs(geo["tokens"], plan["seed"], plan["doc_len"])
        keys, _ = distinct_and_absent(np.concatenate(docs), plan["seed"] + 17)
        zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES)
        store = sharded_store(geo, dev)
        t0 = time.perf_counter()
        two_rank_ingest(store, docs, rank, plan["world"], plan["per_drain"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = store.query_batch(keys)
        t_query = time.perf_counter() - t0
        rec = {"rank": rank, "ingest_s": t_ingest, "lookup_s": t_query,
               "lookup_keys": int(keys.size), **shard_record(store),
               "launches": dict(K.LAUNCHES),
               "baseline_launches": dict(K.BASELINE_LAUNCHES)}
        store.close()
        np.save(workdir / f"answers_{rank}.npy", got)
        (workdir / f"rank_{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def two_rank_phase(seed: int, dev, geo: dict = TWO_RANK,
                   doc_len: int = DOC_LEN) -> dict:
    """Two ranks of a gloo group on ``dev``, two shards each: both ranks'
    answers equal ``np.unique``'s and a single-process run's on the same
    stream and drain cadence; each rank carried nothing and launched all
    three hash kernels on the card. A failed or hung child fails the
    phase, and no child outlives it."""
    import socket

    import numpy as np
    t_phase = time.perf_counter()
    workdir = Path(tempfile.mkdtemp(prefix="flash-sharded-"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    plan = {"geo": geo, "seed": seed + 1, "doc_len": doc_len, "world": 2,
            "per_drain": TWO_RANK_PER_DRAIN, "port": port,
            "timeout": TWO_RANK_TIMEOUT}
    procs, logs = [], []
    try:
        (workdir / "plan.json").write_text(json.dumps(plan))
        t0 = time.perf_counter()
        for rank in range(plan["world"]):
            logs.append(open(workdir / f"log_{rank}.txt", "w"))
            procs.append(subprocess.Popen(
                sharded_child_command(workdir, seed, rank),
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TWO_RANK_TIMEOUT + 60
        for rank, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                for f in logs:
                    f.flush()
                fail(f"sharded 2-rank: rank {rank} ended with {rc}:\n" +
                     "\n".join((workdir / f"log_{r}.txt").read_text()[-3000:]
                               for r in range(plan["world"])))
        t_children = time.perf_counter() - t0
        ranks = [json.loads((workdir / f"rank_{r}.json").read_text())
                 for r in range(plan["world"])]
        answers = [np.load(workdir / f"answers_{r}.npy")
                   for r in range(plan["world"])]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
        shutil.rmtree(workdir, ignore_errors=True)
    docs = make_docs(geo["tokens"], plan["seed"], doc_len)
    keys, want = distinct_and_absent(np.concatenate(docs), plan["seed"] + 17)
    store = sharded_store(geo, dev)
    two_rank_ingest(store, docs, 0, 1, plan["per_drain"])
    one = store.query_batch(keys)
    store.close()
    for r, got in enumerate(answers):
        if not np.array_equal(got, want):
            fail(f"sharded 2-rank: rank {r}: {int((got != want).sum())} of "
                 f"{keys.size} counts differ from np.unique counts")
        if not np.array_equal(got, one):
            fail(f"sharded 2-rank: rank {r} differs from one process")
    for rec in ranks:
        if rec["write_carried"] or rec["dropped"] or any(
                rec["baseline_launches"].values()):
            fail(f"sharded 2-rank: rank {rec['rank']}: {rec}")
        if dev.type == "cuda" and min(rec["launches"].values()) <= 0:
            fail(f"sharded 2-rank: rank {rec['rank']} did not launch every "
                 f"kernel: {rec['launches']}")
    out = {"ranks": ranks, "children_s": t_children,
           "tokens": geo["tokens"], "lookup_keys": int(keys.size),
           "phase_s": time.perf_counter() - t_phase}
    print(f"sharded 2-rank: {json.dumps(out)}", flush=True)
    return out


def tiny_sharded_card_vs_cpu(seed: int, dev) -> dict:
    """A small ±Δ stream through a 4-shard store on ``dev`` and on the CPU,
    MB, MDB and MDB-L: identical global state arrays (every leaf) and
    answers; all three hash kernels launched on the card for each."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import global_arrays
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels.flash_hash import kernel as K
    rng = np.random.default_rng(seed)
    batches = [((rng.zipf(1.3, 1024) % 5000),
                rng.choice(np.array([1, 1, 2, -1]), 1024))
               for _ in range(16)]
    keys = np.arange(6000)
    out = {}
    for scheme in ("MB", "MDB", "MDB-L"):
        runs = {}
        for d in (dev, torch.device("cpu")):
            zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES)
            store = sharded_store(TINY_SHARDED, d, scheme)
            for i, (toks, dels) in enumerate(batches):
                store.update(toks, dels)
                if i % 4 == 3:
                    store.drain()
            store.flush()
            runs[d.type] = (flatten(global_arrays(store.state)),
                            store.query_batch(keys))
            if d.type == "cuda":
                launches = dict(K.LAUNCHES)
            no_baseline(f"tiny sharded {scheme}")
            store.close()
        card, cpu = runs[dev.type], runs["cpu"]
        bad = sorted(k for k in cpu[0]
                     if not np.array_equal(card[0][k], cpu[0][k]))
        if bad or not np.array_equal(card[1], cpu[1]):
            fail(f"tiny sharded {scheme}: the card and the CPU differ in "
                 f"{bad or 'the answers'}")
        if dev.type == "cuda" and min(launches.values()) <= 0:
            fail(f"tiny sharded {scheme}: a kernel never launched on the "
                 f"card: {launches}")
        out[scheme] = {"tile_stores": int(cpu[0]["stats/tile_stores"].sum()),
                       "launches": launches if dev.type == "cuda" else None}
        print(f"tiny sharded {scheme} card == cpu: {json.dumps(out[scheme])}",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 9-12: the serving path
# ---------------------------------------------------------------------------
def smoke_prompts(seed: int, vocab: int, prompt_len: int, shared: int):
    """Request 0 of its own, 1-3 sharing its first ``shared`` tokens, 4-7
    fresh."""
    import numpy as np
    rng = np.random.default_rng(seed)
    fresh = lambda n: rng.integers(0, vocab, n).tolist()
    p0 = fresh(prompt_len)
    return ([p0] + [p0[:shared] + fresh(prompt_len - shared)
                    for _ in range(3)]
            + [fresh(prompt_len) for _ in range(4)])


@contextlib.contextmanager
def watched(model, names, dev, timed: bool):
    """Wrap ``model``'s methods ``names`` for the block: every call's
    logits are checked finite (flags kept on the device, read by the
    caller afterwards) and, when ``timed``, every call is clocked with a
    sync around it. Yields (ms lists by name, finite flags)."""
    import torch
    times = {n: [] for n in names}
    finite = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wrap(name):
        fn = getattr(model, name)

        def run(*a):
            if timed:
                sync()
                t0 = time.perf_counter()
            out = fn(*a)
            if timed:
                sync()
                times[name].append((time.perf_counter() - t0) * 1e3)
            finite.append(torch.isfinite(out[0]).all())
            return out
        return run

    for n in names:
        setattr(model, n, wrap(n))
    try:
        yield times, finite
    finally:
        for n in names:
            delattr(model, n)


def serve(cfg, model, dev, seed: int, geo: dict, timed: bool = False):
    """Serve :func:`smoke_prompts` through ``ServeEngine`` with a fresh
    prefix cache on ``dev``; checks outputs, cached prefixes, cache
    counters and refcounts. Returns its record."""
    from repro_torch.serving import PrefixKVCache, Request, ServeEngine
    cache = PrefixKVCache(block_tokens=geo["block_tokens"],
                          capacity_blocks=geo["capacity_blocks"],
                          backend="device", device=dev,
                          flush_threshold=geo.get("flush_threshold"))
    engine = ServeEngine(cfg, model, prefix_cache=cache)
    prompts = smoke_prompts(seed, cfg.vocab_size, geo["prompt_len"],
                            geo["shared"])
    held = []
    if geo.get("read_pins"):
        # each request's refcounts, read while it still holds its pins
        release = cache.release

        def read_then_release(pinned):
            held.append(cache._count(pinned).tolist())
            release(pinned)
        cache.release = read_then_release
    with watched(model, ("prefill", "decode_step"), dev, timed) as (
            times, finite):
        t0 = time.perf_counter()
        done = engine.serve([Request(prompt=p, max_new_tokens=geo["max_new"])
                             for p in prompts])
        wall = time.perf_counter() - t0
    outputs = [r.output for r in done]
    cached = [r.cached_tokens for r in done]
    # drain what H_R still holds (nothing when every pin cancelled there),
    # so the refcounts below are read from the table itself
    cache._refs.flush()
    stats = cache.stats()
    refs = cache._count(list(cache.store)).tolist()
    cache.close()
    want_cached = [0] + [geo["shared"]] * 3 + [0] * 4
    if any(len(o) != geo["max_new"] or min(o) < 0 or max(o) >= cfg.vocab_size
           for o in outputs):
        fail(f"serve {cfg.name}: outputs are not {geo['max_new']} ids "
             f"below {cfg.vocab_size}: {outputs}")
    if cached != want_cached:
        fail(f"serve {cfg.name}: cached prefixes {cached}, expected "
             f"{want_cached}")
    if (stats["hits"], stats["misses"]) != (3, 5) or stats["evictions"] <= 0:
        fail(f"serve {cfg.name}: hits/misses/evictions {stats}")
    if stats["dropped"] != 0 or any(refs):
        fail(f"serve {cfg.name}: dropped {stats['dropped']}, refcounts "
             f"after release {refs}")
    if not all(bool(f) for f in finite):
        fail(f"serve {cfg.name}: non-finite logits")
    if geo.get("read_pins") and (len(held) != len(prompts)
                                 or min(min(h, default=0) for h in held) < 1):
        fail(f"serve {cfg.name}: a held pin read below 1: {held}")
    return {"outputs": outputs, "cached_tokens": cached, "stats": stats,
            "refs": refs, "held_refs": held, "wall_s": wall, "prefill_ms": times["prefill"],
            "decode_ms": times["decode_step"],
            "tokens": sum(len(o) for o in outputs)}


def serve_phase(seed: int, dev):
    """llama3.2-3b at full width; the flash-attention launches are counted
    over this run alone."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models.model import Model
    cfg = get_config("llama32_3b")
    # two peaks: the process's so far and this phase's own (which counts
    # what earlier phases left allocated)
    before = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t0
    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    rec = serve(cfg, model, dev, seed, SERVE, timed=True)
    no_baseline("serve")
    launches = {**FK.LAUNCHES, **K.LAUNCHES}
    want = {FK.WGMMA: 5 * cfg.num_layers, FK.SIMT: 0}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"serve: flash-attention launches {got}, expected {want} (5 "
             f"prefills x {cfg.num_layers} layers, all bf16 at d=128)")
    decode = rec["decode_ms"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "init_s": t_init, "requests": len(rec["outputs"]),
           "cached_tokens": rec["cached_tokens"],
           "prefill_ms": rec["prefill_ms"],
           "decode_steps": len(decode),
           "decode_ms_per_token": statistics.median(decode),
           "decode_ms_mean": statistics.fmean(decode),
           "generated_tokens": rec["tokens"], "wall_s": rec["wall_s"],
           "tokens_per_s": rec["tokens"] / rec["wall_s"],
           "launches": launches, "prefix_cache": rec["stats"],
           "phase_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "process_peak_gib": max(
               before, torch.cuda.max_memory_allocated(dev)) / 2 ** 30}
    print(f"serve {cfg.name}: {json.dumps(out)}", flush=True)
    return out, model


def continuous(cfg, model, dev, seed: int, geo: dict, timed: bool = False):
    """Replay ``geo``'s seeded trace through ``ContinuousBatchingScheduler``
    with a fresh device prefix cache on ``dev`` (two feeder threads, no
    arrival delays); checks outputs, finite logits, cached prefixes, the
    pool and refcounts. ``timed`` clocks every chunk and packed decode
    with a sync around it. Returns its record."""
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     PrefixKVCache, make_trace, replay_trace)
    tr = geo["trace"]
    bt = tr["block_tokens"]
    cache = PrefixKVCache(block_tokens=bt,
                          capacity_blocks=geo["capacity_blocks"],
                          backend="device", device=dev,
                          flush_threshold=geo.get("flush_threshold"))
    sched = ContinuousBatchingScheduler(cfg, model, prefix_cache=cache,
                                        max_slots=geo["max_slots"],
                                        max_context=geo["max_context"])
    trace = make_trace(**tr, vocab_size=cfg.vocab_size, seed=seed)
    ticks = 0
    step = sched.step

    def counted():
        nonlocal ticks
        did = step()
        ticks += did
        return did
    sched.step = counted
    with watched(model, ("prefill_chunk", "decode_step_packed"), dev,
                 timed) as (times, finite):
        rep = replay_trace(sched, trace, workers=2, time_scale=0)
    done = sorted(sched.completed, key=lambda r: r.request_id)
    outputs = [r.output for r in done]
    cached = [r.cached_tokens for r in done]
    # drain what H_R still holds, so the refcounts are read from the table
    cache._refs.flush()
    stats = cache.stats()
    refs = cache._count(list(cache.store)).tolist()
    cache.close()
    what = f"serve continuous {cfg.name}"
    n_new = tr["max_new_tokens"]
    if len(outputs) != tr["num_requests"] or any(
            len(o) != n_new or min(o) < 0 or max(o) >= cfg.vocab_size
            for o in outputs):
        fail(f"{what}: outputs are not {n_new} ids below {cfg.vocab_size}: "
             f"{outputs}")
    if not all(bool(f) for f in finite):
        fail(f"{what}: non-finite logits")
    if any(c % bt or c > tr["prefix_blocks"] * bt for c in cached):
        fail(f"{what}: cached prefixes {cached} are not block multiples "
             f"within the {tr['prefix_blocks'] * bt}-token system prefix")
    if stats["hits"] <= 0 or stats["evictions"] <= 0:
        fail(f"{what}: no prefix hit or no eviction: {stats}")
    if stats["dropped"] != 0 or any(refs):
        fail(f"{what}: dropped {stats['dropped']}, refcounts after the "
             f"run {refs}")
    return {"outputs": outputs, "cached_tokens": cached, "stats": stats,
            "refs": refs, "ticks": ticks, "chunk_calls": sched.chunk_calls,
            "decode_steps": sched.decode_steps, "report": rep,
            "chunk_ms": times["prefill_chunk"],
            "decode_ms": times["decode_step_packed"]}


def continuous_phase(seed: int, dev, model, serial_tokens_per_s: float):
    """Continuous batching on the serve phase's full-width model; the
    kernels' launches and the peak memory are this run's alone."""
    import statistics

    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    t0 = time.perf_counter()
    rec = continuous(cfg, model, dev, seed, CONTINUOUS, timed=True)
    no_baseline("serve continuous")
    rep = rec["report"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "slots": CONTINUOUS["max_slots"], "requests": rep.requests,
           "ticks": rec["ticks"], "chunk_calls": rec["chunk_calls"],
           "decode_steps": rec["decode_steps"],
           "chunk_ms_median": statistics.median(rec["chunk_ms"]),
           "decode_ms_median": statistics.median(rec["decode_ms"]),
           "wall_s": rep.wall_s, "generated_tokens": rep.generated_tokens,
           "tokens_per_s": rep.tokens_per_s,
           "serial_tokens_per_s": serial_tokens_per_s,
           "p50_latency_s": rep.p50_latency_s,
           "p99_latency_s": rep.p99_latency_s, "hit_rate": rep.hit_rate,
           "wear": rep.wear, "cached_tokens": rec["cached_tokens"],
           "hash_launches": dict(K.LAUNCHES),
           "attention_launches": dict(FK.LAUNCHES),
           "prefix_cache": rec["stats"],
           "phase_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "phase_s": time.perf_counter() - t0}
    print(f"serve continuous {cfg.name}: {json.dumps(out)}", flush=True)
    return out


def tiny_models(seed: int, dev):
    """llama32 TINY in f32 with the same weights on ``dev`` and on the
    CPU → (cfg, models by device type)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                              dtype="float32")
    cpu = torch.device("cpu")
    weights = Model(cfg, device=cpu, seed=seed).state_dict()
    models = {}
    for d in (dev, cpu):
        models[d.type] = Model(cfg, device=d, seed=seed)
        models[d.type].load_state_dict(weights)
    return cfg, models


def tiny_card_vs_cpu(seed: int, dev):
    """llama32 TINY in f32, the same weights on the card and on the CPU:
    identical outputs, cached prefixes, prefix-cache stats and refcounts,
    first as the serial engine leaves them, then drained into the device
    table (every flash-hash kernel launched on the card). Every prefill on
    the card runs the CUDA-core flash-attention kernel; returns its
    launches over the first run."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    cfg, models = tiny_models(seed, dev)
    cpu = torch.device("cpu")
    attn_launches = None
    for name, geo in (("tiny", TINY_SERVE), ("tiny drained", TINY_DRAINED)):
        runs = {}
        timing = TIMING_STATS if geo.get("flush_threshold") else ()
        for d in (dev, cpu):
            zero_launches(K.LAUNCHES, FK.LAUNCHES, K.BASELINE_LAUNCHES)
            rec = serve(cfg, models[d.type], d, seed, geo)
            no_baseline(f"serve {name}")
            stats = {k: v for k, v in rec["stats"].items()
                     if k not in timing}
            runs[d.type] = (rec["outputs"], rec["cached_tokens"], stats,
                            rec["held_refs"], rec["refs"])
            if d.type == "cuda":
                launches = dict(K.LAUNCHES)
                attn = dict(FK.LAUNCHES)
        want = {FK.SIMT: 5 * cfg.num_layers, FK.WGMMA: 0}
        if dev.type == "cuda" and attn != want:
            fail(f"serve {name}: flash-attention launches {attn}, expected "
                 f"{want} (5 f32 prefills x {cfg.num_layers} layers)")
        if attn_launches is None:
            attn_launches = attn[FK.SIMT]
        if runs["cuda"] != runs["cpu"]:
            fail(f"serve {name}: the card and the CPU differ: {runs}")
        if geo.get("flush_threshold") and min(launches.values()) <= 0:
            fail(f"serve {name}: the refcounts never went through a "
                 f"flash-hash kernel on the card: {launches}")
        print(f"serve {name} card == cpu: cached {json.dumps(runs['cpu'][1])}"
              f" held refcounts {json.dumps(runs['cpu'][3])} stats "
              f"{json.dumps(runs['cpu'][2])} card launches "
              f"{json.dumps({**launches, **attn})}", flush=True)
    return attn_launches


def tiny_continuous(seed: int, dev) -> None:
    """The continuous run on the TINY twin, on the card and on the CPU:
    identical outputs, cached prefixes, prefix-cache stats and refcounts,
    and the serial engine's outputs; then drained into the device table,
    where every flash-hash kernel must launch on the card."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.serving import Request, ServeEngine, make_trace
    cfg, models = tiny_models(seed, dev)
    cpu = torch.device("cpu")
    tr = TINY_CONTINUOUS["trace"]
    serial = [r.output for r in ServeEngine(cfg, models["cpu"]).serve(
        [Request(prompt=list(t.prompt), max_new_tokens=t.max_new_tokens)
         for t in make_trace(**tr, vocab_size=cfg.vocab_size, seed=seed)])]
    for name, geo in (("tiny continuous", TINY_CONTINUOUS),
                      ("tiny continuous drained", TINY_CONTINUOUS_DRAINED)):
        runs = {}
        for d in (dev, cpu):
            zero_launches(K.LAUNCHES, FK.LAUNCHES, K.BASELINE_LAUNCHES)
            rec = continuous(cfg, models[d.type], d, seed, geo)
            no_baseline(f"serve {name}")
            stats = {k: v for k, v in rec["stats"].items()
                     if k not in TIMING_STATS}
            runs[d.type] = (rec["outputs"], rec["cached_tokens"], stats,
                            rec["refs"], rec["chunk_calls"],
                            rec["decode_steps"])
            if d.type == "cuda":
                launches = dict(K.LAUNCHES)
        if runs["cuda"] != runs["cpu"]:
            fail(f"serve {name}: the card and the CPU differ: {runs}")
        if runs["cpu"][0] != serial:
            fail(f"serve {name}: outputs differ from the serial engine's: "
                 f"{runs['cpu'][0]} against {serial}")
        if geo.get("flush_threshold") and min(launches.values()) <= 0:
            fail(f"serve {name}: the refcounts never went through a "
                 f"flash-hash kernel on the card: {launches}")
        print(f"serve {name} card == cpu == serial: cached "
              f"{json.dumps(runs['cpu'][1])} chunk calls {runs['cpu'][4]} "
              f"decode steps {runs['cpu'][5]} stats "
              f"{json.dumps(runs['cpu'][2])} card launches "
              f"{json.dumps(launches)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # the durability phase's child: this script, started by the parent
    ap.add_argument("--durability-child", type=Path, help=argparse.SUPPRESS)
    # a rank of the two-rank sharded phase: this script, started by the
    # parent
    ap.add_argument("--sharded-child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
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
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attn import build as fa_build
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import build as fh_build
    from repro_torch.kernels.flash_hash import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.durability_child is not None:
        # the parent built the kernels: load them, never compile again
        fh_build.LIBRARY.build()
        if fh_build.LIBRARY.last_build["seconds"] != 0.0:
            fail("durability child: the flash-hash kernels were rebuilt")
        durability_child(args.durability_child, dev)
        return 1                      # not killed: the parent fails it
    if args.sharded_child is not None:
        import faulthandler
        # a collective that never completes dumps every thread's stack and
        # exits non-zero instead of hanging the parent
        faulthandler.dump_traceback_later(TWO_RANK_TIMEOUT, exit=True)
        fh_build.LIBRARY.build()
        if fh_build.LIBRARY.last_build["seconds"] != 0.0:
            fail("sharded child: the flash-hash kernels were rebuilt")
        sharded_child(args.sharded_child, args.rank, dev)
        return 0
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    libs = [fh_build.LIBRARY, fa_build.LIBRARY]
    t0 = time.perf_counter()
    nvcc.build_all(libs)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        print(f"build {lib.name}: {lib.last_build['seconds']:.1f} s -> "
              f"{lib.last_build['path']}", flush=True)
        print(f"sass {lib.name}: {json.dumps(kernel_report(lib))}",
              flush=True)

    res = kernel_phase(args.seed, dev)
    attn = attention_phase(args.seed, dev)
    runs = [main_path("MDB-L", FULL, args.seed, dev)]
    for scheme in ("MB", "MDB"):
        runs.append(main_path(scheme, SMALL, args.seed + 1, dev))
    main_run = runs[0]
    for r in runs:
        print(f"wear {r['scheme']}: {json.dumps(r['wear'])}")
        print(f"ingest {r['scheme']}: {r['ingest_tokens_per_s']:.0f} tokens/s;"
              f" lookup: {r['lookup_keys_per_s']:.0f} keys/s")
    dur = durability_phase(args.seed, dev)
    print(f"durability ({dur['phase_s']:.1f} s): snapshot "
          f"{dur['snapshot_s']:.3f} s, "
          f"{dur['snapshot_bytes']} bytes; WAL {dur['wal_bytes']} bytes; "
          f"restore {dur['restore_s']:.3f} s ({dur['records_replayed']} "
          f"records, {dur['replayed_entries_per_s']:.0f} replayed entries/s); "
          f"launches in the restore {json.dumps(dur['launches_at_restore'])}"
          f", by the end of the first check "
          f"{json.dumps(dur['launches_at_check'])}, after the whole phase "
          f"{json.dumps(dur['launches'])}; "
          f"card {card}", flush=True)
    t0 = time.perf_counter()
    sims = sim_vs_card(args.seed, dev)
    print(f"sim cleans vs card tile_stores (term table; "
          f"{time.perf_counter() - t0:.1f} s): " + "; ".join(
              f"{k} {v['sim_cleans']} / {v['card_tile_stores']}"
              for k, v in sims.items()), flush=True)
    shard = sharded_phase(args.seed, dev, main_run)
    print(f"sharded MDB-L ({shard['phase_s']:.1f} s; {shard['placement']}): "
          f"ingest {shard['ingest_tokens_per_s']:.0f} tokens/s, lookup "
          f"{shard['lookup_keys_per_s']:.0f} keys/s (single table "
          f"{main_run['ingest_tokens_per_s']:.0f} / "
          f"{main_run['lookup_keys_per_s']:.0f}); {shard['drains']} drains, "
          f"{shard['waves']} waves, tile_stores {shard['tile_stores']} "
          f"{shard['tile_stores_per_shard']}, {shard['merges']} merges, "
          f"{shard['stages']} stages; launches "
          f"{json.dumps(shard['launches'])}; card {card}", flush=True)
    two = two_rank_phase(args.seed, dev)
    print(f"sharded 2-rank ({two['phase_s']:.1f} s, children "
          f"{two['children_s']:.1f} s): " + "; ".join(
              f"rank {r['rank']} ({r['placement']}, {r['collectives']}) "
              f"ingest {r['ingest_s']:.2f} s, lookup {r['lookup_s']:.2f} s, "
              f"{r['waves']} waves, launches {json.dumps(r['launches'])}"
              for r in two["ranks"]) + f"; card {card}", flush=True)
    tiny_sharded_card_vs_cpu(args.seed, dev)
    served, model = serve_phase(args.seed, dev)
    print(f"serve: prefill ms {[round(t, 3) for t in served['prefill_ms']]};"
          f" decode {served['decode_ms_per_token']:.3f} ms/token (median of "
          f"{served['decode_steps']}); {served['tokens_per_s']:.1f} "
          f"generated tokens/s", flush=True)
    cont = continuous_phase(args.seed, dev, model, served["tokens_per_s"])
    del model
    print(f"serve continuous ({cont['phase_s']:.1f} s): {cont['ticks']} "
          f"ticks, chunk {cont['chunk_ms_median']:.3f} ms, packed decode "
          f"{cont['decode_ms_median']:.3f} ms (medians); "
          f"{cont['tokens_per_s']:.1f} generated tokens/s against the "
          f"serial engine's {served['tokens_per_s']:.1f}; card {card}",
          flush=True)
    twin_launches = tiny_card_vs_cpu(args.seed, dev)
    tiny_continuous(args.seed, dev)
    kernels = []
    for name in K.LAUNCHES:
        # the lookup kernels at the layout the path launches them on
        r = res.get(f"{name}_path", res[name])
        kernels.append({
            "name": name, "route": "cuda", "source": CU,
            "replaces": REPLACES[name],
            "launches": main_run["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # each flash-attention kernel at the shape of the path that runs it:
    # the serve prefill (bf16) and the f32 twin's prefill
    for name, case, launches in (
            (FK.WGMMA, "serve", served["launches"][FK.WGMMA]),
            (FK.SIMT, "tiny_f32", twin_launches)):
        r = attn[case]
        kernels.append({
            "name": name, "route": "cuda", "source": FA_CU,
            "replaces": REPLACES["flash_attention"], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
