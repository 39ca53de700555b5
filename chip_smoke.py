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
4. the serving path at full width: llama3.2-3b (28 layers, bf16, weights
   drawn from ``--seed`` on the card) behind ``ServeEngine`` with a
   ``PrefixKVCache(block_tokens=8, capacity_blocks=64)`` whose refcounts
   live in the port's device ``FlashStore``. Eight requests of 512-token
   prompts and 32 new tokens: request 0 fills the pool, requests 1-3
   share its first 256 tokens (prefix hits, the rest decoded token by
   token), requests 4-7 are fresh and evict. Outputs, cached prefixes,
   hits, misses, evictions, refcounts after release and 5 x 28
   launches of the tensor-core flash-attention kernel (and none of the
   CUDA-core one) are checked;
5. the same request order scaled down on llama32 TINY in f32, served on
   the card and on the CPU with the same weights: outputs, cached
   prefixes and cache stats must be identical. The serial engine's pins
   cancel in the store's write buffer, so the twin runs again with a
   flush threshold of 1 (every pin and unpin drained into the device
   table), reading each request's refcounts while it holds its pins: the
   refcounts read back from the table must agree too, and every
   flash-hash kernel must have launched on the card; every prefill of
   the f32 twin runs the CUDA-core flash-attention kernel (and none the
   tensor-core one);
6. a ``kernels`` JSON line, then the card line, then the result line.

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
# phases 4-5: the serving path
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


def serve(cfg, model, dev, seed: int, geo: dict, timed: bool = False):
    """Serve :func:`smoke_prompts` through ``ServeEngine`` with a fresh
    prefix cache on ``dev``; checks outputs, cached prefixes, cache
    counters and refcounts. Returns its record."""
    import torch
    from repro_torch.serving import PrefixKVCache, Request, ServeEngine
    cache = PrefixKVCache(block_tokens=geo["block_tokens"],
                          capacity_blocks=geo["capacity_blocks"],
                          backend="device", device=dev,
                          flush_threshold=geo.get("flush_threshold"))
    engine = ServeEngine(cfg, model, prefix_cache=cache)
    prompts = smoke_prompts(seed, cfg.vocab_size, geo["prompt_len"],
                            geo["shared"])
    times = {"prefill": [], "decode": []}
    finite = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def clocked(fn, sink):
        def run(*a):
            sync()
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            sink.append((time.perf_counter() - t0) * 1e3)
            finite.append(bool(torch.isfinite(out[0]).all()))
            return out
        return run

    if timed:
        model.prefill = clocked(model.prefill, times["prefill"])
        model.decode_step = clocked(model.decode_step, times["decode"])
    held = []
    if geo.get("read_pins"):
        # each request's refcounts, read while it still holds its pins
        release = cache.release

        def read_then_release(pinned):
            held.append(cache._count(pinned).tolist())
            release(pinned)
        cache.release = read_then_release
    t0 = time.perf_counter()
    done = engine.serve([Request(prompt=p, max_new_tokens=geo["max_new"])
                         for p in prompts])
    wall = time.perf_counter() - t0
    if timed:
        del model.prefill, model.decode_step
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
    if not all(finite):
        fail(f"serve {cfg.name}: non-finite logits")
    if geo.get("read_pins") and (len(held) != len(prompts)
                                 or min(min(h, default=0) for h in held) < 1):
        fail(f"serve {cfg.name}: a held pin read below 1: {held}")
    return {"outputs": outputs, "cached_tokens": cached, "stats": stats,
            "refs": refs, "held_refs": held, "wall_s": wall, "prefill_ms": times["prefill"],
            "decode_ms": times["decode"],
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
    return out


def tiny_card_vs_cpu(seed: int, dev):
    """llama32 TINY in f32, the same weights on the card and on the CPU:
    identical outputs, cached prefixes, prefix-cache stats and refcounts,
    first as the serial engine leaves them, then drained into the device
    table (every flash-hash kernel launched on the card). Every prefill on
    the card runs the CUDA-core flash-attention kernel; returns its
    launches over the first run."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                              dtype="float32")
    cpu = torch.device("cpu")
    weights = Model(cfg, device=cpu, seed=seed).state_dict()
    models = {}
    for d in (dev, cpu):
        models[d.type] = Model(cfg, device=d, seed=seed)
        models[d.type].load_state_dict(weights)
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
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attn import build as fa_build
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import build as fh_build
    from repro_torch.kernels.flash_hash import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
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
    served = serve_phase(args.seed, dev)
    print(f"serve: prefill ms {[round(t, 3) for t in served['prefill_ms']]};"
          f" decode {served['decode_ms_per_token']:.3f} ms/token (median of "
          f"{served['decode_steps']}); {served['tokens_per_s']:.1f} "
          f"generated tokens/s", flush=True)
    twin_launches = tiny_card_vs_cpu(args.seed, dev)
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
