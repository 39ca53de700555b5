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
   query) is held to the plain version too. The merge again at the
   paper's flash block (``paper_kernel_case``: 2**24 slots in 256 blocks
   of 65,536, every block listed, rows of 2**15 updates holding 4,096 on
   average), on the cluster route (the tile striped over a thread-block
   cluster's shared memory), the in-place route held to the same plain
   result and timed in turns with it (the serial kernel cannot stage such
   a tile and is not run). Times
   (``check.py``'s docstring): each kernel's device time from CUDA-graph
   replays (``device_ms``; the query kernels cold, with the L2 flushed
   before every launch, and warm), the same for the replaced kernel, and
   for the filter probe the floor of a plain copy of its lanes; its raw
   launches from Python (``ms``) and its wrapper (checks and host sync
   included) in turns of 10 calls between two events; the plain version
   over single calls. The query kernels' cold device times at the path's
   layout are taken again from a ``torch.profiler`` trace (a cross
   check). The two flash-attention kernels against their plain version
   at llama3.2-3b's attention shapes (b=1, h=24, kvh=8, d=dv=128): bf16
   causal at s=512 (the serve phase's prefill), 4096 and a ragged 1000,
   non-causal and with q and k scaled x8 at 512 (the bf16 kernel), f32 at
   512 (the f32 serve's prefill), at 4096 and at the tiny twin's prefill
   (the f32 kernel: three TF32 passes); and at heads whose rows are no
   multiple of 16 bytes, which each kernel's producer warp loads without
   TMA: starcoder2 TINY's (6 / 2 of d = 12) in bf16 at 512 and at a ragged
   1,000 with w = 100, 6 / 2 of d = 10, dv = 5 in bf16 at a ragged 1,000
   (odd rows on 2-byte boundaries), 4 / 2 of 6 in f32 at 512; and at heads
   wider than 256, which each kernel's wide instance takes (d in chunks of
   256, 128 or 64 columns, S once for up to 512 columns of o, slices of
   256 where those CTAs still fit one wave; ``WIDE_CASES``, each also with
   its plan, the f32 pre-pass's own time, its time over SDPA's): 8 / 2 of
   320 at 512 in both dtypes, minicpm3's latent attention (40 / 1, d 288,
   dv 256) at 1,024 in bf16 and 512 in f32, DeepSeek-V3's absorbed MLA
   (128 / 1, d 576, dv 512) at 1,024 in bf16, odd widths on the producer
   warp's route (6 / 2 of 333 / 301 at a ragged 1,000 in bf16; 1,030 /
   517 non-causal at 300 in f32) and 6 / 2 of 512 at 1,000 with w = 100
   in bf16, each also with the names of the kernels SDPA runs there; and
   in f16 (the wgmma kernel's f16 instance, against SDPA in f16): llama's
   heads at 512 and 4,096, starcoder2-7b's at 8,192 with its 4,096-token
   window, starcoder2 TINY's heads of 12 (the producer warp's loads) and
   8 / 2 of 320 (the wide instance); within 2e-2 (bf16) / 4e-3 (f16) /
   2e-5 (f32) with PyTorch's TF32 off; each case's one wrapper
   call must launch the kernel the split names and no other. CUDA-event
   medians timed in turns: the kernel, one
   ``scaled_dot_product_attention`` call (timed only, never on the path;
   at f32 512 and 4096 the profiler's names of the kernels it runs are
   printed) and the plain version, and the first two's device times. The
   sliding-window cases, each held
   against ``sdpa_ref(window=)``: starcoder2-7b's heads at s = 8,192 with
   its 4,096-token window, llama's at a ragged 1,000 with w = 100 and at
   512 with w = 1 (bf16), f32 at 512 with w = 77 and the windowed tiny
   twin's prefill (s = 40, w = 8), and ``bf16_d12_window`` above; each
   prints beside its times the same
   kernel's causal launch at the same s, the windowed FLOP bound, and
   SDPA under the dense boolean band mask;
3. the TF-IDF path end to end: ``TfIdfPipeline`` over ``FlashStore`` with
   MDB-L at the paper's table size (2**24 slots in blocks of 1024, a
   2**21-entry change segment) on a seeded 2**25-token stream of
   documents, then MB and MDB at 2**20 slots on 2**21 tokens. Each run's
   answers for 2**16
   keys (half present, half absent) must equal ``np.unique`` counts of
   its stream, document frequencies included, with nothing dropped; the
   kernels' launch counters are zeroed before each run and must all be
   above 0 after it. Then ``paper_block``: MDB-L with the paper's flash
   block (128 pages of 512 entries: 256 blocks of 65,536 slots, the same
   2**24 slots, half a block of updates a row) on 2**23 tokens of the
   same mix, with the same checks, the merge's cluster route launched and
   no other; and the card against the CPU (``wide_card_vs_cpu``) at blocks
   of 1, 4 and 65,536 slots for MB, MDB and MDB-L: identical answers,
   wear, counters and table state, the route ``merge_route`` names for
   the width launched (in place at 1 and 4 slots, the cluster at 65,536)
   and no other. Both print their seconds. Then the race phase: ``repro_torch.analysis``'s
   race harness attached to a ``FlashStore`` (MDB-L at the same size,
   filters and the default hot cache on, the drain worker on) that takes
   the same stream in 16 ``update`` calls, a 2**16-key lookup after each
   (half present, checked against the running counts), a
   ``drain(wait=False)`` after each odd batch, a ``flush(wait=False)``
   after batch 8 and a ``flush()`` at the end, with a flush threshold
   between one batch's distinct keys and two batches', so drains overlap
   the caller's updates and lookups. Its log must check clean, every
   distinct key's count must equal ``np.unique``'s with nothing dropped,
   all three hash kernels and neither attention kernel must launch under
   the tracer, and every drain and merge job, sampled at its start (at
   least one on the drain worker), must run on the caller's CUDA stream;
   an untraced twin runs
   the same ops on a fresh store with the same answers and wear. Then the
   reference harness tests' three seeded races on the card (each flagged
   as on the CPU), the 4-shard tiny store traced (no finding, every
   shard's partition sealed and cleared) and the port's flashlint over
   ``src/repro_torch``, the ``chip_*.py`` scripts and
   ``tests/test_torch_*.py`` (no violation). It prints the event counts,
   the checker's seconds and the traced and untraced tokens/s;
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
9. the products' result types at llama3.2-3b's shapes
   (``precision_phase``, under 20 s): the f32-result product of bf16
   operands that the port's FFN gate / up / in and logits take
   (``layers.matmul_f32``: ``mm.dtype`` on the card) against the upcast
   form (both operands widened to f32, then an f32 product) in two
   cases, the decode logits (1 x 3,072 by the tied 3,072 x 128,256 head,
   its transposed table as the path reads it) and a prefill FFN gate
   (512 x 3,072 by 3,072 x 8,192): max relative error (max |diff| /
   max |upcast|) within ``PRECISION_TOL``, the memory the call allocates
   beyond its result under ``PRECISION_SLACK`` (no f32 copy of the
   weight), and the backward of the autograd wrapper (``mm.dtype`` has no
   derivative) on the FFN case against the upcast form's; prints each
   case's error and the device times of the f32-result product, the
   upcast form and the bf16 product; the same two cases with f16 operands
   (an f16 model's products, ``<case>_f16``: gradients within one f16
   rounding); then the bf16 products where
   cuBLAS may split the inner dim (``PRECISION_BF16``: decode's and
   prefill's FFN down-products of llama3.2-3b and starcoder2-7b, and a
   weight gradient over rank 0's 16,384 train_4k tokens), each with
   ``allow_bf16_reduced_precision_reduction`` on and off against the f32
   sum rounded once (the lanes that differ, the largest difference in
   bf16 ulps) and the exact sum (the largest error in ulps over the lanes
   whose f32 rounding noise is under a quarter ulp), and the device
   times; with the port's setting (off: every ``Model`` clears it) no
   such lane may be more than one ulp off, nor any lane more than one ulp
   past the f32 sum's noise bound; then the same products in f16 with
   ``allow_fp16_reduced_precision_reduction`` on and off, in f16 ulps
   (``precision f16 <case>``);
   then the serving path at full width: llama3.2-3b (28 layers, bf16, weights
   drawn from ``--seed`` on the card) behind ``ServeEngine`` with a
   ``PrefixKVCache(block_tokens=8, capacity_blocks=64)`` whose refcounts
   live in the port's device ``FlashStore``. Eight requests of 512-token
   prompts and 32 new tokens: request 0 fills the pool, requests 1-3
   share its first 256 tokens (prefix hits, the rest decoded token by
   token), requests 4-7 are fresh and evict. Outputs, cached prefixes,
   hits, misses, evictions, refcounts after release and 5 x 28
   launches of the bf16 tensor-core flash-attention kernel (and no other
   attention kernel) are checked;
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
   phase's tokens/s. Then llama3.2-3b at full width in f32 (its CONFIG
   with ``dtype="float32"``, ~12.8 GB of random weights from ``--seed``):
   the serve run's order with 8 new tokens (``F32_SERVE``) and one
   4,096-token prefill; every prefill must launch the f32 tensor-core
   flash-attention kernel once a layer (28) and no other, and its greedy
   id and last-position logits must agree with the same prefill's with
   attention by the plain version on the card (``plain_attention``),
   within ``F32_LOGIT_TOL`` of the largest logit; it prints prefill times
   of both routes, the gaps and the decode time. Then the same in f16
   (its CONFIG with ``dtype="float16"``, 6.4 GB; ``F16_SERVE``: the same
   order with the hits sharing 504 of 512 tokens; a 4,096-token
   prefill): 28 launches of the wgmma kernel's f16 instance a prefill and
   no other attention kernel, each prefill's logits within
   ``F16_LOGIT_TOL`` of the plain route's largest logit (the greedy ids'
   agreement printed), and the f16 TINY twins (``F16_TWINS``: llama32,
   llama32 with heads of 320, minicpm3, starcoder2 with a window of 8),
   each served on the card and on the CPU with the same weights: every
   card prefill on the f16 instance, its last logits within
   ``F16_TWIN_LOGIT_TOL`` of the CPU's, identical cached prefixes and
   stats;
11. the same request order scaled down on llama32 TINY in f32, served on
   the card and on the CPU with the same weights: outputs, cached
   prefixes and cache stats must be identical. The serial engine's pins
   cancel in the store's write buffer, so the twin runs again with a
   flush threshold of 1 (every pin and unpin drained into the device
   table), reading each request's refcounts while it holds its pins: the
   refcounts read back from the table must agree too, and every
   flash-hash kernel must have launched on the card; every prefill of
   the f32 twin runs the f32 tensor-core flash-attention kernel (and no
   other);
12. the continuous run scaled down on the same TINY twin (3 slots, a
   16-block pool, an 8-request trace of 3 users), on the card and on the
   CPU, then again with a flush threshold of 1: outputs, cached prefixes,
   cache stats and refcounts identical on both, and outputs identical to
   the serial engine's on the CPU; in the drained run every flash-hash
   kernel must have launched on the card;
13. the other model families at full width in bf16, each served as
   llama3.2-3b is (the same eight requests, pool and checks; random
   weights from ``--seed``; each model freed before the next):
   minicpm3-4b (MLA, all 62 layers), granite-moe-1b (MoE, 32 experts
   top-8, all 24), mamba2-2.7b (SSM, all 64; nothing cached, since an SSM
   stack registers only whole prompts) and nemotron-4-340b (2 of its 96
   layers, full width). Every prefill of every attention layer must run
   the bf16 tensor-core flash-attention kernel (and no other);
   init, prefill, decode, tokens/s and the phase's peak are printed.
   Then starcoder2-7b at full width (all 32 layers, 36 / 4 heads of 128,
   bf16) with its published 4,096-token sliding window, served by the
   same engine over a 1,280-block pool of 16 tokens: four 8,192-token
   prompts (#1 shares #0's first 8,176 tokens: 511 blocks hit, its last
   16 prompt tokens decoded against a cache twice the window; #3 evicts),
   32 new tokens each. Checks as above (cached ``[0, 8176, 0, 0]``, 3 x
   32 tensor-core launches), and that the window reaches decode: #1's
   first-token logits from the hit path within ``WINDOW_LOGIT_TOL`` of
   the largest logit of a fresh windowed prefill of its prompt, and the
   same hit path with the window out of decode outside it. The
   attention phase (2) holds the kernel at these families' head shapes
   too: MLA (h = kvh = 40, d 96, dv 64; s = 512 and a ragged 1000),
   granite (16, 8, 64, 64), starcoder2 (36, 4, 128, 128), nemotron (96, 8,
   192, 192);
14. TINY f32 card-vs-CPU twins of the nine other architectures, the same
   weights on both: the serial engine (40-token prompts, 32 for the SSM
   and hybrid stacks) with identical outputs, cached prefixes and stats,
   every attention prefill on the f32 tensor-core kernel; MLA again with a
   flush threshold of 1 (all three hash kernels launched on the card);
   llama32's twin again with a sliding window of 8, with heads of 6
   (24-byte rows, loaded without TMA) and with heads of 320 (the f32
   kernel's wide instance), each prefill's last logits on the card also
   within 2e-5 of the CPU's; then starcoder2's TINY in bf16 (heads of 12)
   and llama32's TINY in bf16 with heads of 320 (the bf16 kernel's wide
   instance) served on the card in the same order, every prefill on the
   bf16 kernel, its last logits within 5e-2 of the same prefill's with
   attention by the plain version on the card;
15. continuous twins of minicpm3, granite, mamba2 and jamba on the card
   and on the CPU: identical outputs, cached prefixes and stats; the
   paged path for MLA and MoE (``TINY_CONTINUOUS``), the whole-prompt
   fallback (no chunk call) for the SSM and hybrid stacks on the
   reference scheduler test's prompts; outputs equal to the serial
   engine's except on the paged MoE stack, whose 16-token chunks route
   with their own expert capacity; llama32's with a window of 8;
16. training at full width: ``repro_torch.launch.train`` (in this
   process) trains llama3.2-3b (28 layers, bf16, random weights from
   ``--seed``) for 8 steps behind the flash-hash TF-IDF document filter
   (``CorpusStats``, 2**16 slots in blocks of 512, over the train CLI's
   512-document corpus), at the train CLI's defaults: global batch 8 of 128
   tokens in 2 microbatches, peak lr 3e-3, 20 warm-up steps, AdamW with
   f32 moments, every group recomputed in the backward pass. No
   checkpoint is written at this width (10 bytes a parameter). Checks:
   finite losses and gradient norms, step 0's loss within 0.5 of
   ln(128,256) + var/2 (var: the variance of step 0's logits over the
   vocabulary, ~0.02**2 x 3072 = 1.23 for tied embeddings drawn
   N(0, 0.02**2); random logits cost ln V + var/2), the mean of the last two losses below step 0's, every
   attention projection of every layer with a nonzero gradient on step
   0's first microbatch, all three hash kernels launched by the filter
   and no flash-attention launch (training attends through the plain
   ``_sdpa``, as the reference trains through its jnp attention), 8
   steps, no restart, no rollback. It prints each step's loss, gradient
   norm and time, the median step time, tokens/s, the aten ops of one
   step (forward, backward and AdamW, counted as ``decode_ops`` counts a
   decode step) and the phase's peak memory;
17. train twins: the TINY f32 llama32, granite-moe-1b (MoE), minicpm3
   (MLA), mamba2 (SSM) and llama32 with a sliding window of 8, each
   trained 4 steps by the train CLI on the card
   and on the CPU with the same weights, checkpointing every 2 steps,
   with a failure injected at step 3 (a restart from step 2's
   checkpoint): equal reports, losses within 1e-4 relative, the same
   kept documents and corpus counts, the hash kernels launched on the
   card. A fresh process (this script under ``--train-child``, reusing
   the kernels built above) resumes the llama twin's card checkpoint and
   trains step 3 again: its loss equals the card run's within 1e-5;
18. the mesh phase: the dry-run (``launch/dryrun.py``, fake tensors over
   a fake process group of 512, this process rank 0) of llama3.2-3b x
   {train_4k, prefill_32k, decode_32k} and granite-moe-1b x decode_32k on
   the 16x16 mesh, printing each cell's plan, microbatches, per-device dot
   FLOPs, HBM bytes, collective bytes by kind, reckoned peak and trace
   time; then rank 0's per-device programs of llama3.2-3b prefill_32k
   (2 sequences of 32,768 tokens, 3 local query heads over 1 KV head,
   ``flash_attn_wgmma_kernel`` on the local heads through ``local_map``)
   and train_4k (one step, 4 microbatches of 4 x 4,096) run for real on
   the card with production-shaped random local shards (collectives move
   no data): their dot FLOPs (the op counter, FlopCounterMode's formulas)
   must equal the dry-run's exactly, ``max_memory_allocated`` must come
   within ``MESH_PEAK_TOL`` of the reckoned peak, the prefill must launch
   the wgmma kernel once a layer a call and nothing else; rank 0's
   train_4k runs once more with the ``--opt`` program
   (``opt_bf16_grads``, ``opt_conv_split``: ``dryrun.cell_plan(...,
   opt=True)``), printing its step ms, its peak and both programs'
   all-reduce bytes by dtype (the ``--opt`` program must move more of
   them in bf16: its three ``pet`` products reduce in bf16); the dry-run
   writes each cell's op listing (``--save-hlo``), whose lines must sum
   to the traced program's dot FLOPs; then the TINY
   f32 llama32 and granite sharded on a simulated 2x4 mesh
   (``LocalTensorMode(8)``, shards on the card): two train steps and a
   decode equal to the unsharded card run within 1e-5 and card == CPU
   within 1e-4; and TINY bf16 llama32's weight gradients (2
   microbatches) sharded against unsharded on the card, each weight's
   relative error printed, the worst within ``MESH_BF16_GRAD_TOL``;
19. a ``families`` JSON line with every record of 13-15, a ``train`` JSON
   line with the records of 16-17, a ``mesh`` JSON line with 18's, a
   ``kernels`` JSON line (each hash kernel's launches on the main path,
   each attention kernel's on the paths that run it: bf16 every family's
   serve and the bf16 starcoder2 TINY serve, f32 the f32 serve and every
   f32 twin; each also with a window (``window_launches``: the windowed
   starcoder2 serve's, the windowed f32 twin's) beside its windowed
   case's error, device time, bound and SDPA time, and with rows that are
   no multiple of 16 bytes (``odd_launches``: the bf16 TINY serve's, the
   f32 twin's with heads of 6) beside its odd case's (``bf16_d12``,
   ``f32_d6``), and its wide instance's (``wide_launches``: the TINY
   twins' with heads of 320) beside each of its ``WIDE_CASES``, as
   ``race_launches`` under the race phase's tracer (0 for attention,
   checked), as ``train_launches`` in phase 16 and as ``mesh_launches``
   in phase 18; the f16 instance's launches are the f16 serve's and its
   TINY twins', beside its cases ``f16``, ``f16_starcoder2_window``,
   ``f16_d12`` and ``wide_f16``), then the card line, then the result
   line. An ``f16`` JSON line before it holds phase 10's f16 records.

Any mismatch or failed phase raises, so the script exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
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
#: the paper's flash block: 128 pages of 512 entries, 65,536 (key, count)
#: slots (the reference cost model's TableGeometry defaults), on FULL's
#: 2**24 slots: 256 blocks, half a block of updates a row as FULL has 512
#: of 1,024; the stream cut to a quarter of FULL's for the time limit
PAPER_BLOCK = dict(q_log2=24, r_log2=16, log_capacity=1 << 21,
                   max_updates_per_block=1 << 15, tokens=1 << 23)
#: the merge case at the paper's block (``paper_kernel_case``): every
#: block listed, rows of max_u updates holding avg_u on average (the
#: path's flushes bring ~8,192 a block), on a table at 0.55 load
PAPER_KERNEL = dict(q_log2=24, r_log2=16, max_u=1 << 15, avg_u=1 << 12,
                    load=0.55)
#: the card against the CPU at widths the staged merge does not take:
#: (q_log2, r_log2) for blocks of 1, 4 and 65,536 slots
WIDE_VS_CPU = ((8, 0), (10, 2), (17, 16))
DOC_LEN = 1 << 14
N_QUERIES = 1 << 16
CHUNK = 1 << 16

#: attention heads (h, kvh, d, dv) of llama3.2-3b and of its TINY twin,
#: and of the other families' prefills: minicpm3's MLA (the latent
#: expanded to 40 heads of nope 64 + rope 32, values of 64),
#: granite-moe-1b, starcoder2-7b (h/kvh = 9) and nemotron-4-340b; and
#: starcoder2's TINY twin (d = 12: no multiple of 8), and heads whose rows
#: are no multiple of 16 bytes in bf16 (d = 10, dv = 5) and in f32 (6)
LLAMA_HEADS = (24, 8, 128, 128)
TINY_HEADS = (4, 2, 16, 16)
STARCODER2_TINY_HEADS = (6, 2, 12, 12)
MLA_HEADS = (40, 40, 96, 64)
GRANITE_HEADS = (16, 8, 64, 64)
STARCODER2_HEADS = (36, 4, 128, 128)
NEMOTRON_HEADS = (96, 8, 192, 192)
ODD_HEADS = (6, 2, 10, 5)
F32_D6_HEADS = (4, 2, 6, 6)
#: heads wider than 256 (each kernel's wide instance: d in chunks, S once
#: for up to 512 columns of o): 320 (two slices of 256 at s = 512: 2 x 64
#: CTAs fit one wave), minicpm3's latent
#: attention (d = kv_lora_rank 256 + qk_rope_dim 32, dv 256; one KV head
#: under 40 query heads), DeepSeek-V3's absorbed MLA (d = kv_lora_rank 512
#: + qk_rope_head_dim 64, dv 512, 128 query heads over one latent head:
#: deepseek-ai/DeepSeek-V3's config.json), odd widths on the producer
#: warp's route (two slices; f32 1,030 / 517: nine chunks, three slices)
#: and a windowed 512
WIDE_HEADS = (8, 2, 320, 320)
MLA_LATENT_HEADS = (40, 1, 288, 256)
ABSORBED_576_HEADS = (128, 1, 576, 512)
WIDE_ODD_HEADS = (6, 2, 333, 301)
WIDE_F32_ODD_HEADS = (6, 2, 1030, 517)
WIDE_WINDOW_HEADS = (6, 2, 512, 512)
#: flash attention cases: (name, s, dtype, causal, heads, q/k scale[,
#: sliding window]); the tiny twin's prefill is its 40-token prompt. The
#: windowed cases: starcoder2-7b's published window (4,096) over twice its
#: length, a window no multiple of a tile over a ragged length, a window
#: of one key, and the f32 kernel at llama's heads and at the windowed
#: tiny twin's prefill (40 tokens, w = 8). The f32 cases run the f32
#: kernel, the others the bf16 one. The last four have rows that are no
#: multiple of 16 bytes, which each kernel's producer warp loads without
#: TMA: starcoder2 TINY's heads in bf16 (d = 12), also over a ragged 1,000
#: with w = 100; d = 10, dv = 5 in bf16 (odd rows on 2-byte boundaries)
#: over a ragged 1,000; f32 heads of 6. The f16 cases (the wgmma kernel's
#: f16 instance, last): llama's heads at 512 (the f16 serve's prefill) and
#: 4,096, starcoder2-7b's at 8,192 with its 4,096-token window, starcoder2
#: TINY's (d = 12, the producer warp's loads) and 8 / 2 of 320 (the wide
#: instance)
ATTN_CASES = [("serve", 512, "bfloat16", True, LLAMA_HEADS, 1.0),
              ("long", 4096, "bfloat16", True, LLAMA_HEADS, 1.0),
              ("ragged", 1000, "bfloat16", True, LLAMA_HEADS, 1.0),
              ("f32", 512, "float32", True, LLAMA_HEADS, 1.0),
              ("f32_long", 4096, "float32", True, LLAMA_HEADS, 1.0),
              ("non_causal", 512, "bfloat16", False, LLAMA_HEADS, 1.0),
              ("qk_x8", 512, "bfloat16", True, LLAMA_HEADS, 8.0),
              ("tiny_f32", 40, "float32", True, TINY_HEADS, 1.0),
              ("mla", 512, "bfloat16", True, MLA_HEADS, 1.0),
              ("mla_ragged", 1000, "bfloat16", True, MLA_HEADS, 1.0),
              ("granite", 512, "bfloat16", True, GRANITE_HEADS, 1.0),
              ("starcoder2", 512, "bfloat16", True, STARCODER2_HEADS, 1.0),
              ("nemotron", 512, "bfloat16", True, NEMOTRON_HEADS, 1.0),
              ("starcoder2_window", 8192, "bfloat16", True,
               STARCODER2_HEADS, 1.0, 4096),
              ("window_ragged", 1000, "bfloat16", True, LLAMA_HEADS, 1.0,
               100),
              ("window_1", 512, "bfloat16", True, LLAMA_HEADS, 1.0, 1),
              ("f32_window", 512, "float32", True, LLAMA_HEADS, 1.0, 77),
              ("tiny_f32_window", 40, "float32", True, TINY_HEADS, 1.0, 8),
              ("bf16_d12", 512, "bfloat16", True, STARCODER2_TINY_HEADS,
               1.0),
              ("bf16_odd", 1000, "bfloat16", True, ODD_HEADS, 1.0),
              ("f32_d6", 512, "float32", True, F32_D6_HEADS, 1.0),
              ("bf16_d12_window", 1000, "bfloat16", True,
               STARCODER2_TINY_HEADS, 1.0, 100),
              ("wide_bf16", 512, "bfloat16", True, WIDE_HEADS, 1.0),
              ("wide_f32", 512, "float32", True, WIDE_HEADS, 1.0),
              ("mla_latent", 1024, "bfloat16", True, MLA_LATENT_HEADS, 1.0),
              ("mla_latent_f32", 512, "float32", True, MLA_LATENT_HEADS,
               1.0),
              ("absorbed_576", 1024, "bfloat16", True, ABSORBED_576_HEADS,
               1.0),
              ("wide_odd", 1000, "bfloat16", True, WIDE_ODD_HEADS, 1.0),
              ("wide_f32_odd", 300, "float32", False, WIDE_F32_ODD_HEADS,
               1.0),
              ("wide_window", 1000, "bfloat16", True, WIDE_WINDOW_HEADS,
               1.0, 100),
              ("f16", 512, "float16", True, LLAMA_HEADS, 1.0),
              ("f16_long", 4096, "float16", True, LLAMA_HEADS, 1.0),
              ("f16_starcoder2_window", 8192, "float16", True,
               STARCODER2_HEADS, 1.0, 4096),
              ("f16_d12", 512, "float16", True, STARCODER2_TINY_HEADS, 1.0),
              ("wide_f16", 512, "float16", True, WIDE_HEADS, 1.0)]
#: the cases of heads wider than 256, by kernel: each prints the kernels
#: SDPA runs there (its flash route stops at 256 columns)
WIDE_CASES = {"flash_attention_wgmma": ("wide_bf16", "mla_latent",
                                        "absorbed_576", "wide_odd",
                                        "wide_window"),
              "flash_attention_tf32x3": ("wide_f32", "mla_latent_f32",
                                         "wide_f32_odd"),
              "flash_attention_wgmma_f16": ("wide_f16",)}
#: attention cases longer than this (f32 and f16: this long) are timed
#: over 3 rounds (the plain version takes ~10 ms a call there)
ATTN_LONG = 4096
#: the serve phase's traffic (full width) and its scaled-down twin (TINY)
SERVE = dict(prompt_len=512, shared=256, max_new=32, block_tokens=8,
             capacity_blocks=64)
TINY_SERVE = dict(prompt_len=40, shared=16, max_new=16, block_tokens=8,
                  capacity_blocks=5)
#: llama3.2-3b in f32 at full width: the serve run's order with 8 new
#: tokens, then one prefill of ``F32_LONG`` tokens; each prefill's
#: last-position logits must sit within ``F32_LOGIT_TOL`` of the largest
#: logit of the same model's with attention by the plain version
F32_SERVE = dict(SERVE, max_new=8)
F32_LONG = 4096
F32_LOGIT_TOL = 1e-3
#: llama3.2-3b in f16 at full width, as the f32 serve (the serve run's
#: order with 8 new tokens, then one ``F16_LONG``-token prefill), but the
#: three hits share 504 of the 512 prompt tokens, so 24 prompt tokens are
#: decoded one by one after their hits instead of 768 (the smoke's time
#: limit: 71 s of host-bound decode steps on a slow host): each prefill's
#: last-position logits within ``F16_LOGIT_TOL`` of the largest logit of
#: the same prefill's with attention by the plain version (f16 rounds P
#: and o to 11 bits, bf16 to 8: between f32's 1e-3 and the bf16 twins'
#: 5e-2)
F16_SERVE = dict(SERVE, shared=504, max_new=8)
F16_LONG = 4096
F16_LOGIT_TOL = 2e-2
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
#: the other families at full width, served as llama3.2-3b is (SERVE):
#: (arch, layers kept or None for all). Widths are never cut; depth is,
#: to keep the smoke well inside its time limit: an eager decode step is
#: host-bound, so a family's serve time grows with its layers (at full
#: depth minicpm3's 62 and granite's 24 took 114-200 s each).
#: nemotron-4-340b keeps 2 of its 96 layers (16.4B parameters, ~33 GB in
#: bf16)
FAMILY_SERVES = (("minicpm3_4b", 8), ("granite_moe_1b", 6),
                 ("mamba2_2p7b", 16), ("nemotron4_340b", 2))
#: every architecture served here besides llama3.2-3b, as TINY f32
#: card-vs-CPU twins of the serial engine; the first two of the
#: continuous ones run the paged path, the last two the whole-prompt
#: fallback of the SSM and hybrid stacks
FAMILY_TWINS = ("granite_moe_1b", "phi35_moe_42b", "minicpm3_4b",
                "starcoder2_7b", "nemotron4_340b", "llava_next_mistral_7b",
                "mamba2_2p7b", "musicgen_large", "jamba15_large_398b")
FAMILY_CONTINUOUS = ("minicpm3_4b", "granite_moe_1b", "mamba2_2p7b",
                     "jamba15_large_398b")
#: the windowed serve at full width: starcoder2-7b with its published
#: 4,096-token window (arXiv:2402.19173; bigcode/starcoder2-7b's
#: config.json), four 8,192-token prompts (twice the window): #0 its own,
#: #1 #0's first 8,176 tokens (511 blocks: a hit that decodes its last 16
#: prompt tokens against a cache twice the window) plus 16 of its own,
#: #2 and #3 fresh; 32 new tokens each; 1,280 blocks of 16 tokens (1.25
#: GiB of KV at 64 KiB a token), so #3 evicts. All 32 layers: the phase
#: takes ~15 s
WINDOW_SERVE = dict(arch="starcoder2_7b", window=4096,
                    prompt_len=8192, shared=8176, max_new=32,
                    block_tokens=16, capacity_blocks=1280)
#: max |hit-path logits - fresh prefill's| / max |fresh prefill's| the
#: windowed hit path may show (see ``window_serve_phase``)
WINDOW_LOGIT_TOL = 0.05
#: the windowed TINY twins: llama32 with a window of 8 (40-token prompts)
TINY_WINDOW = 8
#: llama32's TINY twin with heads of 6 (24-byte f32 rows, loaded without
#: TMA): each prefill's logits on the card within ``TWIN_LOGIT_TOL`` of the
#: CPU's (the f32 kernel's tolerance); starcoder2's TINY in bf16 (heads of
#: 12) against the plain attention route within ``BF16_TWIN_LOGIT_TOL``
#: (``tests/test_torch_model.py``'s bf16 tolerance). The same twins with
#: heads of 320 (``TINY_WIDE_HEAD_DIM``: each kernel's wide instance): the
#: f32 llama32 card against the CPU, the bf16 llama32 against the plain
#: route
TINY_HEAD_DIM = 6
TINY_WIDE_HEAD_DIM = 320
TWIN_LOGIT_TOL = 2e-5
BF16_TWIN_LOGIT_TOL = 5e-2
#: the f16 TINY twins, card against CPU with the same weights: (arch,
#: sliding window, head width or 0 for the config's): llama32, llama32
#: with heads of 320 (the f16 instance's wide kernel), minicpm3 (MLA) and
#: starcoder2 with a window of 8 (heads of 12: the producer warp's
#: loads). Every prefill's last-position logits on the card within
#: ``F16_TWIN_LOGIT_TOL`` of the CPU's, absolute and relative
#: (``tests/test_torch_f16.py``'s logit tolerance against the reference)
F16_TWINS = (("llama32_3b", 0, 0), ("llama32_3b", 0, TINY_WIDE_HEAD_DIM),
             ("minicpm3_4b", 0, 0), ("starcoder2_7b", TINY_WINDOW, 0))
F16_TWIN_LOGIT_TOL = 1e-2
#: the SSM and hybrid stacks' TINY serial order: 32-token prompts (their
#: TINY chunk), 16 shared
TINY_SERVE_SSM = dict(TINY_SERVE, prompt_len=32)
#: their continuous twin: the reference scheduler test's prompts (a shared
#: 16-token block plus 5, 9, 0 and 16 tokens of each one's own: at most
#: 32), 2 slots
TINY_SSM_CONTINUOUS = dict(max_slots=2, max_context=64, capacity_blocks=32,
                           block_tokens=16, shared=16,
                           suffixes=(5, 9, 0, 16), max_new_tokens=8)
#: the tiny train twins: 4 steps, a checkpoint every 2, a failure
#: injected at step 3 (a restart from step 2's checkpoint)
TINY_TRAIN = dict(steps=4, ckpt_every=2, fail_at=3)
TINY_TRAIN_ARCHS = ("llama32_3b", "granite_moe_1b", "minicpm3_4b",
                    "mamba2_2p7b")
#: windowed train twins: (arch, sliding window)
TINY_TRAIN_WINDOWED = (("llama32_3b", TINY_WINDOW),)
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
# the race phase: the main path's MDB-L stream in 16 update calls, a
# lookup of 2**16 keys after each, a drain after each odd batch and an
# early flush after batch 8
RACE = dict(batches=16, queries=1 << 16, flush_at=8)
#: the seeded interleavings' store: the reference harness tests' geometry
RACE_SEEDED = dict(scheme="MDB-L", q_log2=8, r_log2=4, log_capacity=64,
                   cs_partitions=4, max_updates_per_block=32,
                   overflow_capacity=128, flush_threshold=10_000)
RACE_TOUCHED_MAX = 5000          # the checker is quadratic in these
#: the mesh phase: dry-run cells traced on the host (16×16), the rank-0
#: programs run on the card, the simulated 2×4 TINY twins
MESH_DRYRUN = (("llama32_3b", "train_4k"), ("llama32_3b", "prefill_32k"),
               ("llama32_3b", "decode_32k"), ("granite_moe_1b", "decode_32k"))
MESH_RUNS = ("prefill_32k", "train_4k")
MESH_TINY = ("llama32_3b", "granite_moe_1b")
#: the precision check's cases at llama3.2-3b's shapes: (name, rows,
#: d_model, columns, the weight read transposed as the tied head is)
PRECISION_CASES = (("decode_logits", 1, 3072, 128256, True),
                   ("prefill_ffn_gate", 512, 3072, 8192, False))
#: max |f32-result product - upcast form| / max |upcast form|: both sum
#: the same exact products of bf16 values in f32, in other orders (about
#: sqrt(3072) x 2**-24 a sum, 3e-6)
PRECISION_TOL = 1e-5
#: bytes the f32-result product may allocate beyond its result (an f32
#: copy of the tied head would be 1.58e9)
PRECISION_SLACK = 64 << 20
#: bf16-result products with a long inner dim, where cuBLAS may reduce
#: split-K partials in bf16: (name, rows, inner, columns, the first
#: operand a transposed view). Decode's and prefill's FFN down-products
#: of llama3.2-3b (d_ff 8,192 → 3,072; its serve's 512-token prompts)
#: and starcoder2-7b (18,432 → 4,608; its windowed serve's 8,192-token
#: prompts), and w_down's gradient h^T g on rank 0's train_4k shard
#: (16x16: 4 sequences of 4,096 tokens a microbatch, 512 of its ffn
#: lanes)
PRECISION_BF16 = (("decode_down_llama3.2-3b", 1, 8192, 3072, False),
                  ("decode_down_starcoder2-7b", 1, 18432, 4608, False),
                  ("prefill_down_llama3.2-3b", 512, 8192, 3072, False),
                  ("prefill_down_starcoder2-7b", 8192, 18432, 4608, False),
                  ("wgrad_down_train_4k_rank0", 512, 16384, 3072, True))
#: TINY bf16 llama32's weight gradients, sharded (2x4) against unsharded
#: on the card: max relative error (norm-wise) over the weights. Both sum
#: each product in f32 and round once, the forward's activations may
#: round apart by one bf16 ulp (2**-8)
MESH_BF16_GRAD_TOL = 2e-2
#: a rank-0 run's max_memory_allocated against its dry-run's reckoned peak
MESH_PEAK_TOL = 0.10
RACE_KINDS = {"hr_write", "seal", "swap", "inflight_clear", "state_rebind",
              "invalidate", "cache_insert", "job_start", "job_end"}


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
            args = re.findall(
                r"Li(\d+)E|^I(f)|13(__nv_bfloat16)|6(__half)|Lb([01])E",
                rest[:rest.find("EE") + 1])
            args = [{"f": "float", "b0": "false", "b1": "true"}.get(
                "".join(a[:4]) or "b" + a[4], "".join(a)) for a in args]
            return f"{ident}<{','.join(args)}>"
    return mangled


def kernel_report(lib) -> dict:
    """Each kernel of a built library: its static SASS counts of HGMMA,
    UTMALDG, UBLKCP, SYNCS and LDG and its registers and spills from
    ``ptxas``. Fails if an instance of a tensor-core attention kernel (bf16,
    f16 or f32) has no HGMMA, or one of the staged or cluster merge no
    bulk copy."""
    from repro_torch.kernels import nvcc
    ptxas = nvcc.ptxas_report(lib.last_build["log"])
    out = {}
    for mangled, counts in nvcc.sass_counts(Path(lib.last_build["path"]))\
            .items():
        name = kernel_name(mangled)
        out[name] = {**counts, **ptxas.get(mangled, {})}
        if ("wgmma" in name or "tf32x3" in name) and counts["HGMMA"] == 0:
            fail(f"{name}: no HGMMA instruction in its SASS")
        if (name.startswith(("merge_dirty_kernel", "merge_dirty_cluster"))
                and counts["UBLKCP"] == 0):
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
        for who in ("", "serial_", "staged_", "in_place_"):
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


def paper_kernel_case(seed: int, dev, geo: dict = PAPER_KERNEL,
                      reps: int = 10) -> dict:
    """``merge_dirty`` at the paper's flash block against its plain
    version (exact, every output): the cluster route, every block listed
    in a shuffled order, and the in-place route held to the same plain
    result and timed in turns with it (``in_place_*``). The table is
    filled by rounds of parallel probing (``check.probe_fill_table``: a
    plain merge would step once per key of the fullest block); the plain
    version runs once, timed by the one call the check makes (a row of
    ~8,192 updates is as many steps)."""
    from repro_torch.core.hashing import Pow2Hash
    from repro_torch.kernels.flash_hash import check as C
    from repro_torch.kernels.flash_hash import kernel as K
    t0 = time.perf_counter()
    pair = Pow2Hash(geo["q_log2"], geo["r_log2"])
    n_b = pair.num_slots
    table = C.probe_fill_table(pair, geo["load"], seed + 5, dev)
    blocks, uk, uc = C.merge_case(pair, table[0], n_b, geo["max_u"],
                                  geo["avg_u"], 0, seed + 6)
    r = C.check_merge_dirty(pair, table, blocks, uk, uc, reps=reps,
                            plain_once=True,
                            baselines=("serial", "in_place"))
    r.update(phase_s=time.perf_counter() - t0, q_log2=geo["q_log2"],
             r_log2=geo["r_log2"], n_d=n_b, max_u=geo["max_u"],
             updates=int((uk != K.EMPTY).sum()),
             cluster_plan=vars(K.cluster_plan(geo["r_log2"])),
             cluster_capacity=(K.cluster_capacity(K.cluster_plan(
                 geo["r_log2"])) if dev.type == "cuda" else None))
    print(f"kernel merge_dirty_paper_block: {json.dumps(r)}", flush=True)
    if r["max_abs_err"] != 0 or r.get("in_place_max_abs_err", 0) != 0:
        fail("merge_dirty at the paper's block disagrees with its plain "
             "version")
    if dev.type == "cuda" and r["route"] != "cluster":
        fail(f"merge_dirty at r_log2={geo['r_log2']} took {r['route']}")
    times = "; ".join(f"{k} {r[k]:.5g} ms ({r[k[:-2] + 'bound_share']:.1%} "
                      f"of the bound)" for k in (
                          "device_ms", "in_place_device_ms", "ms",
                          "in_place_ms", "wrapper_ms") if r.get(k))
    print(f"merge_dirty_paper_block ({r['route']}, {r['phase_s']:.1f} s): "
          f"{times}; plain {r['plain_ms']:.5g} ms; bound "
          f"{r['bound_ms']:.5g} ms ({r['bound_by']}); serial: "
          f"{r.get('serial_skipped', 'run')}", flush=True)
    return r


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
    zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES, K.MERGE_ROUTES)
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
    routes = dict(K.MERGE_ROUTES)
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
           "merge_routes": routes, "r_log2": geo["r_log2"], "wear": wear,
           "query_filter_negatives": stats["query_filter_negatives"],
           "query_tile_loads": stats["query_tile_loads"],
           "write_overlap_us": stats["write_overlap_us"],
           "write_stall_us": stats["write_stall_us"],
           "write_dispatches": stats["write_dispatches"]}
    print(f"main path {scheme}: {json.dumps(out)}", flush=True)
    out["answers"] = (keys, got)
    return out


def only_route(routes: dict, r_log2: int) -> bool:
    """Whether the merge launched on the route ``merge_route`` names for
    blocks of ``2**r_log2`` slots, and on no other."""
    from repro_torch.kernels.flash_hash import kernel as K
    want = K.merge_route(r_log2)
    return routes[want] > 0 and all(
        n == 0 for route, n in routes.items() if route != want)


def paper_block(seed: int, dev, geo: dict = PAPER_BLOCK,
                doc_len: int = DOC_LEN, n_queries: int = N_QUERIES) -> dict:
    """The main path (MDB-L) at the paper's flash block, with
    ``main_path``'s checks, and the merge launched on the cluster route
    (the route its width takes) alone."""
    t0 = time.perf_counter()
    out = main_path("MDB-L", geo, seed, dev, doc_len=doc_len,
                    n_queries=n_queries)
    routes = out["merge_routes"]
    if dev.type == "cuda" and not only_route(routes, geo["r_log2"]):
        fail(f"paper_block: the merge's routes launched {routes}, not the "
             f"cluster one alone")
    out["phase_s"] = time.perf_counter() - t0
    print(f"paper_block ({out['phase_s']:.1f} s): ingest "
          f"{out['ingest_tokens_per_s']:.0f} tokens/s; lookup "
          f"{out['lookup_keys_per_s']:.0f} keys/s; wear "
          f"{json.dumps(out['wear'])}; routes {json.dumps(routes)}",
          flush=True)
    return out


def wide_stream(seed: int, n_keys: int, batches: int = 10):
    """``(op, keys, deltas)``: updates over ``n_keys`` ids (a quarter of
    the table at most), some with deltas of -1 to 2, lookups and one
    flush half-way."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for i in range(batches):
        yield "update", rng.integers(0, n_keys, 160), None
        if i % 4 == 1:
            yield "update", rng.integers(0, n_keys, 40), \
                rng.integers(-1, 3, 40)
        if i % 3 == 2:
            yield "query", rng.integers(0, n_keys * 7 // 6, 80), None
        if i == batches // 2:
            yield "flush", None, None


def wide_card_vs_cpu(seed: int, dev, geos=WIDE_VS_CPU) -> dict:
    """The device ``FlashStore`` on the card and on the CPU (the plain
    versions, which tier-1 holds against the reference) at block widths
    the staged merge does not take, for every scheme, on one stream: the
    same answers, ``wear()``, counters (but the wall-clock ones) and
    table state; on the card the merge's route for the width (in place at
    1 and 4 slots, the cluster at 65,536) launched and no other."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.core.store import FlashStore
    from repro_torch.kernels.flash_hash import kernel as K
    t0 = time.perf_counter()
    out = {}
    for q_log2, r_log2 in geos:
        n_keys = min(3000, (1 << q_log2) // 4)
        for scheme in ("MB", "MDB", "MDB-L"):
            # drains inline: the hot cache's counters then do not depend
            # on when a background drain lands
            kw = dict(scheme=scheme, track_wear=True, async_flush=False,
                      q_log2=q_log2,
                      r_log2=r_log2, log_capacity=256,
                      max_updates_per_block=16,
                      cs_partitions=min(4, 1 << (q_log2 - r_log2)),
                      overflow_capacity=256, chunk=64, flush_threshold=96,
                      query_chunk=64, hot_capacity=64)
            zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES, K.MERGE_ROUTES)
            runs = []
            for where in ("cpu", dev):
                st = FlashStore.open(backend="device", device=where, **kw)
                got = []
                for op, a, b in wide_stream(seed + q_log2, n_keys):
                    if op == "update":
                        st.update(a, b)
                    elif op == "query":
                        got.append(st.query_batch(a))
                    else:
                        st.flush()
                st.flush()
                got.append(st.query(np.arange(-1, n_keys * 7 // 6)))
                stats = {k: v for k, v in st.stats().items()
                         if k not in ("write_overlap_us", "write_stall_us")}
                runs.append((got, st.wear(), stats,
                             convert.state_to_numpy(st.state)))
                st.close()
            (a_got, a_wear, a_stats, a_state), (b_got, b_wear, b_stats,
                                                b_state) = runs
            name = f"r_log2={r_log2} {scheme}"
            if not all(np.array_equal(x, y) for x, y in zip(a_got, b_got)):
                fail(f"card vs CPU {name}: answers differ")
            if a_wear != b_wear or a_wear["dropped"] != 0:
                fail(f"card vs CPU {name}: wear {b_wear} vs {a_wear}")
            if a_stats != b_stats:
                fail(f"card vs CPU {name}: counters differ")
            for f in ("keys", "counts", "log_keys", "ov_keys",
                      "filter_words"):
                if not np.array_equal(a_state[f], b_state[f]):
                    fail(f"card vs CPU {name}: {f} differs")
            routes = dict(K.MERGE_ROUTES)
            if dev.type == "cuda" and not only_route(routes, r_log2):
                fail(f"card vs CPU {name}: merge routes {routes}")
            out[name] = {"wear": b_wear, "merge_routes": routes,
                         "launches": dict(K.LAUNCHES)}
    phase_s = time.perf_counter() - t0
    print(f"wide card vs cpu ({phase_s:.1f} s): identical answers, wear, "
          f"counters and state; {json.dumps(out)}", flush=True)
    out["phase_s"] = phase_s
    return out


def attention_only(name: str, n: int) -> dict:
    """The flash-attention launch counts of a run that launched kernel
    ``name`` ``n`` times and no other attention kernel."""
    from repro_torch.kernels.flash_attn import kernel as FK
    return {k: n if k == name else 0 for k in FK.LAUNCHES}


def attention_phase(seed: int, dev, cases=ATTN_CASES, reps: int = 30):
    """The flash-attention kernels against their plain version; each case
    must run (one wrapper call, one launch) the kernel the dtype/shape
    split names for it."""
    import torch
    from repro_torch.kernels.flash_attn import check as FC
    from repro_torch.kernels.flash_attn import kernel as FK
    res = {}
    for name, s, dtype, causal, (h, kvh, d, dv), qk_scale, *w in cases:
        dt = getattr(torch, dtype)
        window = w[0] if w else 0
        long = s > ATTN_LONG or (dtype != "bfloat16" and s == ATTN_LONG)
        r = FC.check_flash_attention(1, s, h, kvh, d, dv, dt, causal,
                                     seed + s, dev,
                                     reps=min(reps, 3) if long else reps,
                                     qk_scale=qk_scale, window=window)
        wide = any(name in c for c in WIDE_CASES.values())
        if dev.type == "cuda" and (wide or name in (
                "f32", "f32_long", "f16", "f16_long")):
            # which kernels the library call runs (the profiler's names)
            r["library_kernels"] = FC.library_kernels(
                1, s, h, kvh, d, dv, dt, causal, seed + s, dev, window)
        print(f"kernel flash_attention {name}: {json.dumps(r)}", flush=True)
        want = FK.kernel_for(dt, d, dv) if dev.type == "cuda" else "plain"
        if r["kernel"] != want or (dev.type == "cuda" and r["launches"] !=
                                   attention_only(want, 1)):
            fail(f"flash_attention {name} ran {r['kernel']} (launches "
                 f"{r['launches']}), not {want}")
        if not (r["finite"] and r["within_tolerance"]):
            fail(f"flash_attention {name} ({r['kernel']}) disagrees with "
                 f"its plain version (max abs err {r['max_abs_err']}, "
                 f"tolerance {r['tolerance']})")
        shares = "; ".join(
            f"{k} {r[k]:.5g} ms ({r[k[:-2] + 'bound_share']:.1%} of the "
            f"bound)" for k in ("device_ms", "ms", "library_device_ms",
                                "library_ms", "plain_ms") if r.get(k))
        causal_note = (
            f"; window {window}: causal launch at the same s "
            f"{r['causal_device_ms']:.5g} ms ({r['causal_device_bound_share']:.1%}"
            f" of its bound {r['causal_bound_ms']:.5g} ms), windowed / causal "
            f"{r['device_ms'] / r['causal_device_ms']:.3f}"
            if r.get("causal_device_ms") else "")
        print(f"flash_attention {name} ({r['kernel']}, {r['loads']} "
              f"loads): {shares}; bound "
              f"{r['bound_ms']:.5g} ms ({r['bound_by']}){causal_note}",
              flush=True)
        if wide:
            print(f"flash_attention {name} wide: {wide_note(r)}", flush=True)
        res[name] = r
    # the f32 wide instance's pre-pass alone at wide_f32's shape, bit for
    # bit against its plain version
    h, kvh, d, dv = WIDE_HEADS
    r = FC.check_tf32_split(1, 512, h, kvh, d, dv, seed + 512, dev,
                            reps=reps)
    print(f"kernel {FK.TF32X3_SPLIT}: {json.dumps(r)}", flush=True)
    if r["mismatches"]:
        fail(f"{FK.TF32X3_SPLIT}: {r['mismatches']} elements differ from "
             f"its plain version")
    res["tf32_split"] = r
    return res


def wide_note(r: dict) -> str:
    """A wide case's plan (CTAs a query tile, warpgroups with columns of o,
    d's chunks, Q resident or streamed, the load route), the f32 pre-pass's
    own device time, and the kernel's time over SDPA's in the same call
    beside its share of the bound."""
    p = r["plan"]
    note = (f"{p['ctas_per_query_tile']} CTA(s) a query tile (o in "
            f"slices of {p['slice_cols']}), "
            f"{p['warpgroups_with_columns']} warpgroup(s) with columns of o, "
            f"d in {p['d_chunks']} chunk(s) of {p['d_chunk']}, Q "
            f"{'resident' if p['q_resident'] else 'streamed'}, loads "
            f"{p['loads']}")
    if r.get("split_device_ms"):
        note += (f"; pre-pass {r['split_device_ms']:.5g} ms (its bound "
                 f"{r['split_bound_ms']:.5g} ms), "
                 f"{r['split_device_ms'] / r['device_ms']:.1%} of the call")
    if r.get("library_ratio"):
        note += (f"; {r['library_ratio']:.3f}x SDPA "
                 f"({r['device_bound_share']:.1%} of the bound, SDPA "
                 f"{r['library_device_bound_share']:.1%})")
    return note


# ---------------------------------------------------------------------------
# the race phase: the race harness over the drain worker on the card
# ---------------------------------------------------------------------------
def race_plan(batches, seed: int, n_keys: int):
    """The race phase's lookups and threshold: ``n_keys`` keys (half
    distinct keys of the stream, half absent), each key's expected count
    after every batch (a running sum), and a flush threshold between one
    batch's distinct keys and two batches'."""
    import numpy as np
    rng = np.random.default_rng(seed)
    per = [np.unique(b, return_counts=True) for b in batches]
    uniq = np.unique(np.concatenate([u for u, _ in per]))
    half = n_keys // 2
    keys = np.concatenate([rng.choice(uniq, half, replace=False),
                           rng.integers(1 << 30, 1 << 31, n_keys - half)])
    run, want = np.zeros(n_keys, np.int64), []
    for bu, bc in per:
        i = np.minimum(np.searchsorted(bu, keys), bu.size - 1)
        run = run + np.where(bu[i] == keys, bc[i], 0)
        want.append(run)
    one = per[0][0].size
    two = np.union1d(per[0][0], per[1][0]).size
    return keys, want, (one + two) // 2


def race_store(geo: dict, dev, flush_threshold: int):
    """The race phase's store: MDB-L at ``geo`` on ``dev``, filters on,
    the default hot cache (4,096 keys), the drain worker on."""
    from repro_torch.core.store import FlashStore
    cfg = {k: v for k, v in geo.items() if k != "tokens"}
    return FlashStore.open(scheme="MDB-L", device=dev, chunk=CHUNK,
                           query_chunk=CHUNK, flush_threshold=flush_threshold,
                           async_flush=True, **cfg)


def race_run(store, batches, keys, want, flush_at: int) -> dict:
    """The race phase's op sequence on one store: after batch ``b`` (from
    1) a lookup of ``keys``, checked against the running counts; a
    ``drain(wait=False)`` after each odd batch, a ``flush(wait=False)``
    after batch ``flush_at``, a ``flush()`` at the end and the lookup
    again. Returns the answers and the sequence's wall time."""
    import numpy as np
    answers = []
    t0 = time.perf_counter()
    for b, batch in enumerate(batches, start=1):
        store.update(batch)
        answers.append(store.query_batch(keys))
        if not np.array_equal(answers[-1], want[b - 1]):
            fail(f"race: after batch {b}, "
                 f"{int((answers[-1] != want[b - 1]).sum())} of {keys.size} "
                 "counts differ from the stream's")
        if b % 2:
            store.drain(wait=False)
        if b == flush_at:
            store.flush(wait=False)
    store.flush()
    mix_s = time.perf_counter() - t0
    answers.append(store.query_batch(keys))
    if not np.array_equal(answers[-1], want[-1]):
        fail("race: counts after the last flush differ from the stream's")
    return {"answers": answers, "mix_s": mix_s}


def seeded_interleavings(dev) -> dict:
    """The reference harness tests' three seeded races on ``dev``, each a
    one-line regression injected through a monkeypatched hook of a live
    store; each must be flagged as it is on the CPU: invalidate before
    rebind (exactly one ``unfenced-rebind``), a double seal without
    settling (exactly one ``data-race``, on ``hr:inflight``), a cache
    clear without the epoch bump (exactly one ``stale-cache-insert``)."""
    import threading

    import numpy as np
    from repro_torch.analysis import race_harness as RH
    from repro_torch.core.store import FlashStore
    out = {}

    st = FlashStore.open(device=dev, **RACE_SEEDED)
    eng = st._b.writer
    tr = RH.attach(st)
    st.update(np.arange(64))
    orig = eng._dispatch

    def bad_dispatch(keys, dels):
        eng._invalidate()                      # fence first (the bug)
        qe, eng.query_engine = eng.query_engine, None
        try:
            orig(keys, dels)                   # ...rebind after, unfenced
        finally:
            eng.query_engine = qe

    eng._dispatch = bad_dispatch
    st.drain(wait=True)
    eng._dispatch = orig
    out["invalidate_before_rebind"] = tr.check()
    st.close()

    st = FlashStore.open(device=dev, **RACE_SEEDED)
    eng = st._b.writer
    tr = RH.attach(st)
    gate = threading.Event()
    eng.update(np.arange(32))
    sealed = eng.seal()

    def gated_drain():
        gate.wait(timeout=30)
        eng._dispatch(*sealed)

    eng.dispatcher.submit(gated_drain, label="gated-drain#1")
    eng.update(np.arange(100, 140))
    eng.front._inflight[0] = None              # re-seal unsettled (the bug)
    eng.seal()
    gate.set()
    eng.dispatcher.wait()
    out["double_seal"] = tr.check()
    st.close()

    st = FlashStore.open(device=dev, **RACE_SEEDED)
    qe = st._b.query_engine
    tr = RH.attach(st)
    st.update(np.arange(64))
    st.flush()
    orig_lookup, fired = qe._lookup, []

    def bad_lookup(state, q):
        res = orig_lookup(state, q)
        if not fired:                          # mid-lookup, exactly once
            fired.append(1)
            qe._trace("invalidate", "cache", "w", epoch=qe._epoch)
            qe._hot.clear()                    # no epoch bump (the bug)
        return res

    qe._lookup = bad_lookup
    st.query(np.arange(16))
    qe._lookup = orig_lookup
    out["stale_cache_insert"] = tr.check()
    st.close()

    want = {"invalidate_before_rebind": "unfenced-rebind",
            "double_seal": "data-race",
            "stale_cache_insert": "stale-cache-insert"}
    for name, kind in want.items():
        if [f.kind for f in out[name]] != [kind]:
            fail(f"race: seeded {name}: expected one {kind}, got "
                 + "\n".join(f.describe() for f in out[name]))
    if {e.resource for e in out["double_seal"][0].events} != {"hr:inflight"}:
        fail("race: the seeded double seal raced on another resource: "
             + out["double_seal"][0].describe())
    return {name: [f.kind for f in got] for name, got in out.items()}


def traced_sharded(seed: int, dev) -> dict:
    """The tiny-sharded geometry (4 shards, MDB-L) traced on ``dev``: a
    ±Δ stream with overlapped drains and lookups must give no finding,
    with ``state_rebind`` events and a seal and an in-flight clear of
    every shard's H_R partition."""
    import numpy as np
    from repro_torch.analysis import race_harness as RH
    rng = np.random.default_rng(seed)
    store = sharded_store(TINY_SHARDED, dev, "MDB-L")
    tracer = RH.attach(store)
    keys = np.arange(6000)
    for i in range(16):
        store.update(rng.zipf(1.3, 1024) % 5000,
                     rng.choice(np.array([1, 1, 2, -1]), 1024))
        if i % 4 == 3:
            store.drain(wait=False)
        if i % 4 == 1:
            store.query_batch(keys[:1024])
    store.flush()
    store.query_batch(keys)
    store.close()
    findings = tracer.check()
    if findings:
        fail("race: the traced sharded store: "
             + "\n".join(f.describe() for f in findings))
    events = tracer.events
    rebinds = sum(e.kind == "state_rebind" for e in events)
    parts = [f"hr:inflight[{p}]" for p in range(TINY_SHARDED["num_shards"])]
    for kind in ("seal", "inflight_clear"):
        got = {e.resource for e in events if e.kind == kind}
        if not set(parts) <= got:
            fail(f"race: the traced sharded store: {kind} on {sorted(got)}, "
                 f"not on every shard's partition {parts}")
    if rebinds == 0:
        fail("race: the traced sharded store recorded no state_rebind")
    return {"events": len(events), "state_rebinds": rebinds,
            "findings": 0}


def flashlint_check() -> dict:
    """The port's flashlint over ``src/repro_torch``, the ``chip_*.py``
    scripts and ``tests/test_torch_*.py``, in process: no violation."""
    from repro_torch.analysis import flashlint
    paths = ([SRC / "repro_torch"] + sorted(ROOT.glob("chip_*.py"))
             + sorted((ROOT / "tests").glob("test_torch_*.py")))
    t0 = time.perf_counter()
    violations, n_files = flashlint.lint_paths(paths)
    if n_files == 0 or violations:
        fail(f"flashlint: {len(violations)} violation(s) in {n_files} "
             "file(s):\n" + "\n".join(v.format() for v in violations))
    return {"files": n_files, "violations": 0,
            "seconds": time.perf_counter() - t0}


def race_phase(seed: int, dev, geo: dict = FULL, doc_len: int = DOC_LEN,
               plan: dict = RACE) -> dict:
    """The race harness on the card. A store at ``geo`` with the race
    tracer attached runs the main path's stream in ``plan["batches"]``
    update calls with lookups, drains and flushes interleaved
    (``race_run``); its log must check clean, every distinct key's count
    must equal ``np.unique``'s, nothing dropped; all three hash kernels
    launched under the tracer; the drain worker and the caller on one
    CUDA stream. An untraced twin runs the same ops on a fresh store:
    the same answers and wear. Then the seeded interleavings, the traced
    sharded store and flashlint."""
    import threading

    import numpy as np
    import torch
    from repro_torch.analysis import race_harness as RH
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    t_phase = time.perf_counter()
    batches = np.array_split(np.concatenate(make_docs(geo["tokens"], seed,
                                                      doc_len)),
                             plan["batches"])
    keys, want, threshold = race_plan(batches, seed + 19, plan["queries"])

    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    store = race_store(geo, dev, threshold)
    tracer = RH.attach(store)
    cuda = dev.type == "cuda"
    caller = threading.get_ident()
    streams = {torch.cuda.current_stream(dev).cuda_stream} if cuda else set()
    disp = store._b._disp
    submit = disp.submit
    jobs = []                  # (thread, stream) at each drain/merge job's start

    def sampling(fn, label=None):
        def job():
            jobs.append((threading.get_ident(),
                         torch.cuda.current_stream(dev).cuda_stream
                         if cuda else None))
            fn()
        submit(job, label=label)

    disp.submit = sampling
    traced = race_run(store, batches, keys, want, plan["flush_at"])
    launches = {**K.LAUNCHES, **FK.LAUNCHES}
    uniq, cnt = np.unique(np.concatenate(batches), return_counts=True)
    t0 = time.perf_counter()
    got = store.query_batch(uniq)
    t_check = time.perf_counter() - t0
    if not np.array_equal(got, cnt):
        fail(f"race: {int((got != cnt).sum())} of {uniq.size} distinct keys' "
             "counts differ from np.unique counts of the stream")
    wear = store.wear()
    store.close()
    if wear["dropped"] != 0:
        fail(f"race: entries dropped: {wear}")
    worker_jobs = sum(t != caller for t, _ in jobs)
    if worker_jobs == 0:
        fail(f"race: no drain or merge job ran on the drain worker "
             f"({len(jobs)} job(s), all on the caller)")
    streams |= {st for _, st in jobs if st is not None}
    if cuda and len(streams) != 1:
        fail(f"race: the drain worker and the caller launched on "
             f"different CUDA streams: {sorted(streams)}")
    if cuda and min(launches[name] for name in K.LAUNCHES) <= 0:
        fail(f"race: a kernel never launched under the tracer: {launches}")
    if any(launches[name] for name in FK.LAUNCHES):
        fail(f"race: attention launched in the hash store's run: {launches}")
    no_baseline("race")
    events = tracer.events
    touched = sum(1 for e in events if e.resource is not None and e.rw)
    if touched > RACE_TOUCHED_MAX:
        fail(f"race: {touched} touched events, above the checker's "
             f"{RACE_TOUCHED_MAX}")
    t0 = time.perf_counter()
    findings = tracer.check()
    t_checker = time.perf_counter() - t0
    if findings:
        fail("race: the traced store's log: "
             + "\n".join(f.describe() for f in findings[:10]))
    kinds = {e.kind for e in events}
    if not RACE_KINDS <= kinds:
        fail(f"race: event kinds {sorted(RACE_KINDS - kinds)} missing")

    store = race_store(geo, dev, threshold)
    twin = race_run(store, batches, keys, want, plan["flush_at"])
    twin_wear = store.wear()
    store.close()
    if any(not np.array_equal(a, b)
           for a, b in zip(traced["answers"], twin["answers"])):
        fail("race: the untraced twin's answers differ from the traced "
             "store's")
    if twin_wear != wear:
        fail(f"race: wear traced {wear} != untraced {twin_wear}")

    seeded = seeded_interleavings(dev)
    sharded = traced_sharded(seed, dev)
    lint = flashlint_check()
    tokens = int(sum(b.size for b in batches))
    out = {"q_log2": geo["q_log2"], "tokens": tokens,
           "batches": plan["batches"], "flush_threshold": int(threshold),
           "lookup_keys": int(keys.size), "distinct": int(uniq.size),
           "events": len(events), "touched_events": touched,
           "event_kinds": {k: sum(e.kind == k for e in events)
                           for k in sorted(kinds)},
           "checker_s": t_checker, "findings": 0,
           "traced_mix_s": traced["mix_s"],
           "traced_tokens_per_s": tokens / traced["mix_s"],
           "untraced_mix_s": twin["mix_s"],
           "untraced_tokens_per_s": tokens / twin["mix_s"],
           "check_keys_per_s": uniq.size / t_check,
           "jobs": len(jobs), "worker_jobs": worker_jobs,
           "streams": len(streams), "launches": launches, "wear": wear,
           "seeded": seeded, "sharded": sharded, "flashlint": lint,
           "phase_s": time.perf_counter() - t_phase}
    print(f"race MDB-L: {json.dumps(out)}", flush=True)
    return out


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

        def run(*a, **kw):
            if timed:
                sync()
                t0 = time.perf_counter()
            out = fn(*a, **kw)
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


def attn_layers(cfg) -> int:
    """The layers whose prefill runs the flash-attention kernel."""
    return cfg.num_groups * cfg.layer_pattern.count("attn")


def serve(cfg, model, dev, seed: int, geo: dict, timed: bool = False):
    """Serve :func:`smoke_prompts` through ``ServeEngine`` with a fresh
    prefix cache on ``dev``; checks outputs, cached prefixes, cache
    counters and refcounts. An SSM or hybrid stack registers only each
    prompt's whole-block prefix (no slicer), so nothing is cached and
    every request misses. Returns its record."""
    from repro_torch.models.model import has_ssm
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
    ssm = has_ssm(cfg)
    want_cached = [0] * 8 if ssm else [0] + [geo["shared"]] * 3 + [0] * 4
    if any(len(o) != geo["max_new"] or min(o) < 0 or max(o) >= cfg.vocab_size
           for o in outputs):
        fail(f"serve {cfg.name}: outputs are not {geo['max_new']} ids "
             f"below {cfg.vocab_size}: {outputs}")
    if cached != want_cached:
        fail(f"serve {cfg.name}: cached prefixes {cached}, expected "
             f"{want_cached}")
    if (stats["hits"], stats["misses"]) != ((0, 8) if ssm else (3, 5)) or (
            not ssm and stats["evictions"] <= 0):
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


def decode_ops(model, dev) -> int:
    """The aten ops one ``decode_step`` dispatches (batch 1, after a
    16-token prefill): the host's work per generated token, which sets an
    eager decode step's time. Run after a phase's launches are read."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import model as M

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = model.cfg
    toks = torch.zeros((1, 16), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        _, caches = model.prefill(toks, M.zero_frontend_embeds(cfg, model))
        caches = M.pad_caches(cfg, caches, 17)
        with Count() as count:
            model.decode_step(toks[:, :1], caches, 16)
    return count.n


def precision_phase(seed: int, dev, card: str, reps: int = 20) -> dict:
    """``PRECISION_CASES`` on the card (see the module docstring, 9):
    the port's f32-result product of bf16 operands, and then of f16 ones
    (``mm.dtype`` for an f16 model's products), against the upcast form,
    the memory it allocates, its backward, and the device times of the
    f32-result product, the upcast form and the product in the operands'
    type (CUDA events around ``reps`` calls each, in turns); then
    :func:`low_products` in bf16 and in f16."""
    import torch
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for low, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        for name, m, d, n, tied in PRECISION_CASES:
            key = name if low == "bf16" else f"{name}_{low}"
            out[key] = precision_case(gen, dev, card, key, m, d, n, tied,
                                      low, dt, reps)
    out["bf16"] = low_products(seed, dev, card, torch.bfloat16, reps)
    out["f16"] = low_products(seed, dev, card, torch.float16, reps)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"precision ({out['phase_s']:.1f} s): torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return out


def precision_case(gen, dev, card: str, name: str, m: int, d: int, n: int,
                   tied: bool, low: str, dt, reps: int) -> dict:
    """One ``PRECISION_CASES`` case with operands in ``dt`` (``low`` its
    short name)."""
    import torch
    from repro_torch.models import layers as L
    x = (torch.randn(m, d, generator=gen, device=dev)).to(dt)
    if tied:                 # the table (V, d), read as its transpose
        w = (torch.randn(n, d, generator=gen, device=dev)
             * 0.02).to(dt).t()
    else:
        w = (torch.randn(d, n, generator=gen, device=dev)
             / d ** 0.5).to(dt)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = L.matmul_f32(x, w)
    torch.cuda.synchronize(dev)
    extra = torch.cuda.max_memory_allocated(dev) - base - \
        got.numel() * got.element_size()
    want = x.float() @ w.float()
    err = float((got - want).abs().max() / want.abs().max())
    low_err = float((x @ w).float().sub(want).abs().max()
                    / want.abs().max())
    if got.dtype != torch.float32 or not torch.isfinite(got).all():
        fail(f"precision {name}: result {got.dtype}, not finite f32")
    if err > PRECISION_TOL:
        fail(f"precision {name}: max relative error {err} against the "
             f"upcast form, over {PRECISION_TOL}")
    if extra > PRECISION_SLACK:
        fail(f"precision {name}: the f32-result product allocated "
             f"{extra} bytes beyond its result")
    calls = {"f32_result": lambda: L.matmul_f32(x, w),
             "upcast": lambda: x.float() @ w.float(),
             low: lambda: x @ w}
    ms = {k: [] for k in calls}
    for _ in range(3):                      # in turns
        for k, fn in calls.items():
            fn()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize(dev)
            ms[k].append(t0.elapsed_time(t1) / reps)
    rec = {"shape": [m, d, n], "max_rel_err": err,
           f"{low}_max_rel_err": low_err, "extra_bytes": extra,
           **{f"{k}_ms": min(v) for k, v in ms.items()}}
    if not tied:
        # the backward: x's gradient an f32-result product of the
        # cotangent rounded to dt, handed on in x's type; w's in w's
        xg = x.clone().requires_grad_(True)
        wg = w.clone().requires_grad_(True)
        g = torch.randn(m, n, generator=gen, device=dev)
        L.matmul_f32(xg, wg).backward(g)
        gb = g.to(dt).float()
        gx = gb @ w.float().t()
        gw = x.float().t() @ gb
        rec["grad_x_rel_err"] = float(
            (xg.grad.float() - gx).abs().max() / gx.abs().max())
        rec["grad_w_rel_err"] = float(
            (wg.grad.float() - gw).abs().max() / gw.abs().max())
        if xg.grad.dtype != dt or wg.grad.dtype != dt:
            fail(f"precision {name}: gradients in {xg.grad.dtype} / "
                 f"{wg.grad.dtype}, not the operands' {low}")
        # both rounded once to dt (2**-8 relative at most in bf16, 2**-11
        # in f16: half the type's eps)
        if max(rec["grad_x_rel_err"], rec["grad_w_rel_err"]) > \
                torch.finfo(dt).eps / 2:
            fail(f"precision {name}: gradients {rec}")
    print(f"precision {name}: {json.dumps(rec)}; card {card}", flush=True)
    return rec


def half_ulps(a, b):
    """|a - b| in ulps of their 16-bit type (bf16 or f16), lane by lane:
    the distance between their bit patterns on a line ordered like the
    values."""
    import torch

    def key(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (key(a) - key(b)).abs()


def low_products(seed: int, dev, card: str, dt, reps: int = 20) -> dict:
    """``PRECISION_BF16`` on the card with operands in ``dt`` (bf16 or
    f16): each product with cuBLAS's reduced-precision split-K reduction
    allowed and cleared (``allow_bf16_reduced_precision_reduction`` or
    ``allow_fp16_...``). Against the f32 sum rounded once (the f32 product
    of the same values, TF32 off): the lanes that differ and the largest
    difference in ulps of dt; two f32 sums in other orders differ by their
    rounding noise, which on a lane whose terms nearly cancel is many of
    that lane's ulps. So against the exact sum (f64): the largest error in
    ulps of the exact value over the lanes where that noise is under a
    quarter ulp (``sqrt(inner) · 2**-23 · (|x| @ |w|)``: ``conditioned``;
    f16's ulp is 8 times bf16's, so fewer lanes are), which one rounding
    keeps within half an ulp and more roundings need not; over every lane,
    the largest error past that noise bound (``max_excess_ulps``), and the
    lanes where the flag's two settings differ; and the device times (CUDA
    events around ``reps`` calls, in turns). Fails if, with the flag
    cleared (the port's setting), a conditioned lane is more than one ulp
    off, or any lane more than one ulp past the noise bound (in f16 the
    conditioned lanes are few or none at these inner dims: its ulp is
    under the f32 sum's noise)."""
    import torch
    mm = torch.backends.cuda.matmul
    low = "bf16" if dt == torch.bfloat16 else "f16"
    flag = ("allow_bf16_reduced_precision_reduction" if low == "bf16"
            else "allow_fp16_reduced_precision_reduction")
    tf32 = mm.allow_tf32
    mm.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    nmant = round(-math.log2(torch.finfo(dt).eps))   # 7 bf16, 10 f16
    out = {}
    try:
        for name, m, k, n, xt in PRECISION_BF16:
            if xt:
                x = torch.randn(k, m, generator=gen, device=dev).to(dt).t()
            else:
                x = torch.randn(m, k, generator=gen, device=dev).to(dt)
            w = (torch.randn(k, n, generator=gen, device=dev)
                 / k ** 0.5).to(dt)
            ref = (x.float() @ w.float()).to(dt)
            exact = x.double() @ w.double()
            ulp = torch.exp2(torch.floor(torch.log2(
                exact.abs().clamp(min=2.0 ** -120))) - nmant)
            noise = (x.double().abs() @ w.double().abs()) * (k ** 0.5
                                                             * 2.0 ** -23)
            keep = noise < 0.25 * ulp
            rec = {"shape": [m, k, n], "lanes": m * n,
                   "conditioned_lanes": int(keep.sum())}
            ms, got = {}, {}
            for label, on in (("on", True), ("off", False)):
                setattr(mm, flag, on)
                got[label] = x @ w
                u = half_ulps(got[label], ref)
                rec[f"lanes_off_{label}"] = int((u > 0).sum())
                rec[f"max_ulps_{label}"] = int(u.max())
                dev_ulps = (got[label].double() - exact).abs() / ulp
                err = dev_ulps[keep]
                rec[f"max_err_ulps_{label}"] = (float(err.max())
                                                if err.numel() else 0.0)
                # every lane: the error past the f32 sum's noise bound
                rec[f"max_excess_ulps_{label}"] = float(
                    (dev_ulps - noise / ulp).max())
                ms[label] = []
                del u, err, dev_ulps
            rec["lanes_on_vs_off"] = int((got["on"] != got["off"]).sum())
            del got, noise
            for _ in range(3):                  # in turns
                for label, on in (("on", True), ("off", False)):
                    setattr(mm, flag, on)
                    x @ w
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    for _ in range(reps):
                        x @ w
                    t1.record()
                    torch.cuda.synchronize(dev)
                    ms[label].append(t0.elapsed_time(t1) / reps)
            rec.update({f"ms_{k_}": min(v) for k_, v in ms.items()})
            out[name] = rec
            print(f"precision {low} {name}: {json.dumps(rec)}; card {card}",
                  flush=True)
            if rec["max_err_ulps_off"] > 1:
                fail(f"precision {low} {name}: a conditioned lane "
                     f"{rec['max_err_ulps_off']} ulps off the exact sum with "
                     f"the flag cleared")
            if rec["max_excess_ulps_off"] > 1:
                fail(f"precision {low} {name}: a lane "
                     f"{rec['max_excess_ulps_off']} ulps past the f32 sum's "
                     f"noise bound with the flag cleared")
            del x, w, ref, exact, ulp, keep
    finally:
        setattr(mm, flag, False)
        mm.allow_tf32 = tf32
    return out


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
    want = attention_only(FK.WGMMA, 5 * cfg.num_layers)
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"serve: flash-attention launches {got}, expected {want} (5 "
             f"prefills x {cfg.num_layers} layers, all bf16 at d=128)")
    decode = rec["decode_ms"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "init_s": t_init, "requests": len(rec["outputs"]),
           "decode_ops": decode_ops(model, dev),
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


@contextlib.contextmanager
def plain_attention():
    """For the block, every ``flash_attention_fwd`` call computes attention
    with the plain version (``ref.sdpa_ref``) on the tensors' own device
    instead of launching a kernel: the f32 phase's reference route. The
    package's own route is restored after."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref
    fwd = FK.flash_attention_fwd
    FK.flash_attention_fwd = lambda q, k, v, causal=True, window=0: \
        ref.sdpa_ref(q, k, v, causal=causal, window=window)
    try:
        yield
    finally:
        FK.flash_attention_fwd = fwd


def f32_serve_phase(seed: int, dev, card: str, geo: dict = F32_SERVE,
                    long_len: int = F32_LONG) -> dict:
    """llama3.2-3b's CONFIG at full width in f32 (``dtype="float32"``: 28
    layers, d 3,072, 24 / 8 heads of 128; random weights from ``seed``,
    ~12.8 GB): :func:`typed_serve_phase` on the f32 tensor-core kernel,
    within ``F32_LOGIT_TOL``."""
    return typed_serve_phase(seed, dev, card, "float32", F32_LOGIT_TOL, geo,
                             long_len, need_greedy=True)


def f16_serve_phase(seed: int, dev, card: str, geo: dict = F16_SERVE,
                    long_len: int = F16_LONG) -> dict:
    """llama3.2-3b's CONFIG at full width in f16 (``dtype="float16"``: 28
    layers, 3.21B parameters, 6.4 GB of random weights from ``seed``):
    :func:`typed_serve_phase` on the wgmma kernel's f16 instance, within
    ``F16_LOGIT_TOL``; the greedy ids' agreement with the plain route is
    printed (two logits closer than the kernel's rounding may swap)."""
    return typed_serve_phase(seed, dev, card, "float16", F16_LOGIT_TOL, geo,
                             long_len, need_greedy=False)


def typed_serve_phase(seed: int, dev, card: str, dtype: str, tol: float,
                      geo: dict, long_len: int, need_greedy: bool) -> dict:
    """llama3.2-3b's CONFIG at full width in ``dtype``, served by
    ``ServeEngine`` over a device ``PrefixKVCache`` in the serve run's
    order (``geo``: 8 new tokens), then one ``long_len``-token prefill.
    Every prefill must launch the dtype's flash-attention kernel
    (``kernel.kernel_for``) once a layer and no other attention kernel.
    Then each prefill runs again on the same inputs with attention by the
    plain version on the card (:func:`plain_attention`, which launches
    nothing): the last-position logits must agree within ``tol`` of the
    largest logit, and with ``need_greedy`` the greedy ids too. The model
    is freed before it returns."""
    import dataclasses
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("llama32_3b"), dtype=dtype)
    short = {"float32": "f32", "float16": "f16", "bfloat16": "bf16"}[dtype]
    kernel = FK.kernel_for(getattr(torch, dtype), cfg.head_dim,
                           cfg.head_dim)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    model = M.Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t_phase
    params = sum(p.numel() for p in model.parameters())
    runs = keep_prefills(model)   # each prefill: inputs, logits, launches
    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    rec = serve(cfg, model, dev, seed, geo, timed=True)
    no_baseline(f"serve {cfg.name} {short}")
    rng = np.random.default_rng(seed + long_len)
    tok = torch.tensor([rng.integers(0, cfg.vocab_size, long_len).tolist()],
                       dtype=torch.int64, device=dev)
    runs_long = keep_prefills(model)
    with torch.inference_mode():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        model.prefill(tok, M.zero_frontend_embeds(cfg, model))
        torch.cuda.synchronize(dev)
        long_ms = (time.perf_counter() - t0) * 1e3
    del model.prefill
    runs += runs_long
    launches = {**FK.LAUNCHES, **K.LAUNCHES}
    name = f"serve {cfg.name} {short}"
    want = attention_only(kernel, attn_layers(cfg))
    for i, r in enumerate(runs):
        if r["launches"] != want:
            fail(f"{name}: prefill {i} ({r['tokens'].shape[1]} tokens) "
                 f"launched {r['launches']}, expected {want}")
    if len(runs) != rec["stats"]["misses"] + 1:
        fail(f"{name}: {len(runs)} prefills, expected "
             f"{rec['stats']['misses']} misses and the long one")
    # the same prefills with attention by the plain version on the card
    gaps, greedy, plain_ms = [], [], []
    with torch.inference_mode(), plain_attention():
        before = dict(FK.LAUNCHES)
        for r in runs:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            want_logits = model.prefill(r["tokens"], *r["args"])[0][0, -1]
            torch.cuda.synchronize(dev)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            want_logits = want_logits.float()
            gaps.append(logit_gap(r["logits"], want_logits, cfg.vocab_size))
            greedy.append(
                int(r["logits"][:cfg.vocab_size].argmax())
                == int(want_logits[:cfg.vocab_size].argmax()))
        if FK.LAUNCHES != before:
            fail(f"{name}: the plain route launched {FK.LAUNCHES}")
    if (need_greedy and not all(greedy)) or max(gaps) > tol:
        fail(f"{name}: the kernel's prefills against the plain route: "
             f"greedy ids equal {greedy}, logit gaps {gaps} (at most "
             f"{tol} of the largest logit)")
    decode = rec["decode_ms"]
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
           "parameters": params, "init_s": t_init,
           "cached_tokens": rec["cached_tokens"],
           "prefill_ms": rec["prefill_ms"], "long_prefill_tokens": long_len,
           "long_prefill_ms": long_ms, "plain_prefill_ms": plain_ms,
           "logit_gaps": gaps, "greedy_equal": greedy,
           "decode_steps": len(decode),
           "decode_ms_per_token": statistics.median(decode),
           "generated_tokens": rec["tokens"], "wall_s": rec["wall_s"],
           "tokens_per_s": rec["tokens"] / rec["wall_s"],
           "launches": launches, "prefix_cache": rec["stats"],
           "phase_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del model, runs
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{name}: {json.dumps(out)}", flush=True)
    print(f"{name} ({params} parameters; {out['phase_s']:.1f} s): prefill "
          f"ms {[round(x, 3) for x in out['prefill_ms']]}, {long_len} "
          f"tokens {long_ms:.3f} ms (plain route "
          f"{[round(x, 3) for x in plain_ms]}); largest logit gap "
          f"{max(gaps):.4g} of the largest logit, greedy ids equal "
          f"{sum(greedy)} of {len(greedy)}; decode "
          f"{out['decode_ms_per_token']:.3f} ms/token; "
          f"{FK.LAUNCHES[kernel]} launches of {kernel}; peak "
          f"{out['phase_peak_gib']:.2f} GiB; card {card}", flush=True)
    return out


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


def whole_prompt_requests(seed: int, vocab: int, geo: dict):
    """The reference scheduler test's prompts: ``geo["shared"]`` tokens
    shared, then ``geo["suffixes"]`` of each one's own."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, geo["shared"]).tolist()
    return [shared + rng.integers(1, vocab, n).tolist()
            for n in geo["suffixes"]]


def continuous_whole_prompt(cfg, model, dev, seed: int, geo: dict):
    """An SSM or hybrid stack through ``ContinuousBatchingScheduler``: its
    whole-prompt fallback (no chunk call, nothing pooled or cached), the
    packed decode over the recurrent state, a fresh device prefix cache on
    ``dev``. Checks outputs, finite logits, cached prefixes, chunk calls
    and refcounts; returns the same record as :func:`continuous`."""
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     PrefixKVCache, SchedRequest)
    cache = PrefixKVCache(block_tokens=geo["block_tokens"],
                          capacity_blocks=geo["capacity_blocks"],
                          backend="device", device=dev,
                          flush_threshold=geo.get("flush_threshold"))
    sched = ContinuousBatchingScheduler(cfg, model, prefix_cache=cache,
                                        max_slots=geo["max_slots"],
                                        max_context=geo["max_context"])
    prompts = whole_prompt_requests(seed, cfg.vocab_size, geo)
    n_new = geo["max_new_tokens"]
    with watched(model, ("prefill", "decode_step_packed"), dev, False) as (
            _, finite):
        done = sched.run([SchedRequest(prompt=p, max_new_tokens=n_new,
                                       request_id=i)
                          for i, p in enumerate(prompts)])
    done = sorted(done, key=lambda r: r.request_id)
    outputs = [r.output for r in done]
    cached = [r.cached_tokens for r in done]
    cache._refs.flush()
    stats = cache.stats()
    refs = cache._count(list(cache.store)).tolist()
    cache.close()
    what = f"serve continuous {cfg.name}"
    if len(outputs) != len(prompts) or any(
            len(o) != n_new or min(o) < 0 or max(o) >= cfg.vocab_size
            for o in outputs):
        fail(f"{what}: outputs are not {n_new} ids below {cfg.vocab_size}: "
             f"{outputs}")
    if not all(bool(f) for f in finite):
        fail(f"{what}: non-finite logits")
    if sched.chunk_calls or any(cached) or refs:
        fail(f"{what}: the whole-prompt fallback ran {sched.chunk_calls} "
             f"chunks, cached {cached}, left refcounts {refs}")
    return {"outputs": outputs, "cached_tokens": cached, "stats": stats,
            "refs": refs, "chunk_calls": sched.chunk_calls,
            "decode_steps": sched.decode_steps, "prompts": prompts}


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


def tiny_models(seed: int, dev, arch: str = "llama32_3b", window: int = 0,
                head_dim: int = 0):
    """``arch``'s TINY in f32 (with a sliding ``window`` if > 0, heads of
    ``head_dim`` if > 0) with the same weights on ``dev`` and on the CPU →
    (cfg, models by device type)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch, tiny=True)
    cfg = dataclasses.replace(cfg, dtype="float32", sliding_window=window,
                              head_dim=head_dim or cfg.head_dim)
    cpu = torch.device("cpu")
    weights = Model(cfg, device=cpu, seed=seed).state_dict()
    models = {}
    for d in (dev, cpu):
        models[d.type] = Model(cfg, device=d, seed=seed)
        models[d.type].load_state_dict(weights)
    return cfg, models


def keep_prefills(model) -> list:
    """Until the next serve's timer (or a ``del model.prefill``) removes
    it, every ``model.prefill`` call appends to the list returned its
    inputs, its last-position logits (f32) and the flash-attention
    launches it made."""
    from repro_torch.kernels.flash_attn import kernel as FK
    runs = []
    prefill = model.prefill

    def kept(tokens, *args):
        before = dict(FK.LAUNCHES)
        out = prefill(tokens, *args)
        runs.append({"tokens": tokens, "args": args,
                     "logits": out[0][0, -1].float().clone(),
                     "launches": {k: FK.LAUNCHES[k] - before[k]
                                  for k in FK.LAUNCHES}})
        return out
    model.prefill = kept     # the serve's timer wraps it and removes both
    return runs


def tiny_bf16_serve(seed: int, dev, arch: str = "starcoder2_7b",
                    head_dim: int = 0) -> dict:
    """``arch``'s TINY in bf16 (starcoder2's heads of 12: 24-byte rows,
    which the bf16 kernel loads without TMA; heads of ``head_dim`` if > 0),
    random weights from ``seed`` on the card, served by the serial engine
    in the serve tiny order (``TINY_SERVE``). Every prefill must launch the
    bf16 flash-attention kernel once an attention layer and no other
    attention kernel; then
    each prefill runs again on the same inputs with attention by the plain
    version on the card (:func:`plain_attention`): its last-position
    logits must agree within ``BF16_TWIN_LOGIT_TOL`` (absolute and
    relative, as ``tests/test_torch_model.py`` holds bf16 logits to the
    reference's)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="bfloat16")
    cfg = dataclasses.replace(cfg, head_dim=head_dim or cfg.head_dim)
    model = M.Model(cfg, device=dev, seed=seed)
    runs = keep_prefills(model)
    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    rec = serve(cfg, model, dev, seed, TINY_SERVE)
    launches = dict(FK.LAUNCHES)
    name = f"serve tiny {arch} bf16" + (f" head_dim {head_dim}" if head_dim
                                        else "")
    no_baseline(name)
    want = attention_only(FK.WGMMA, attn_layers(cfg))
    if len(runs) != rec["stats"]["misses"] or any(
            r["launches"] != want for r in runs):
        fail(f"{name}: prefills launched "
             f"{[r['launches'] for r in runs]}, expected {want} each for "
             f"{rec['stats']['misses']} misses")
    gaps = []
    with torch.inference_mode(), plain_attention():
        for r in runs:
            plain = model.prefill(r["tokens"], *r["args"])[0][0, -1].float()
            got, plain = r["logits"][:cfg.vocab_size], plain[:cfg.vocab_size]
            gaps.append(float((got - plain).abs().max()))
            if not torch.allclose(got, plain, rtol=BF16_TWIN_LOGIT_TOL,
                                  atol=BF16_TWIN_LOGIT_TOL):
                fail(f"{name}: the kernel's prefill logits against the "
                     f"plain route's differ by {gaps[-1]} (tolerance "
                     f"{BF16_TWIN_LOGIT_TOL})")
    if FK.LAUNCHES != launches:
        fail(f"{name}: the plain route launched a kernel")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "head_dim": cfg.head_dim,
           "outputs": rec["outputs"], "cached_tokens": rec["cached_tokens"],
           "prefills": len(runs), "logit_max_abs_diff": gaps,
           "attention_launches": launches}
    print(f"{name}: {json.dumps(out)}", flush=True)
    return out


def tiny_f16_twin(seed: int, dev, arch: str, window: int = 0,
                  head_dim: int = 0) -> dict:
    """``arch``'s TINY in f16 (a sliding ``window`` if > 0, heads of
    ``head_dim`` if > 0), the same weights on the card and on the CPU,
    each served by the serial engine in the tiny order (``TINY_SERVE``).
    Every prefill on the card must launch the wgmma kernel's f16 instance
    once an attention layer and no other attention kernel, and its
    last-position logits must agree with the same prefill's on the CPU
    within ``F16_TWIN_LOGIT_TOL`` (absolute and relative); the cached
    prefixes and cache stats, which follow from the prompts, must be
    identical. The outputs' agreement is printed, not required: the two
    devices may round an f16 sum an ulp apart, and two logits closer
    than that may swap a greedy id."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float16",
                              sliding_window=window)
    cfg = dataclasses.replace(cfg, head_dim=head_dim or cfg.head_dim)
    cpu = torch.device("cpu")
    weights = Model(cfg, device=cpu, seed=seed).state_dict()
    name = (f"serve tiny {arch} f16" + (f" window {window}" if window else "")
            + (f" head_dim {head_dim}" if head_dim else ""))
    runs, recs = {}, {}
    for where, d in (("card", dev), ("cpu", cpu)):
        model = Model(cfg, device=d, seed=seed)
        model.load_state_dict(weights)
        runs[where] = keep_prefills(model)
        zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
        recs[where] = serve(cfg, model, d, seed, TINY_SERVE)
        no_baseline(name)
        if where == "card":
            attn = dict(FK.LAUNCHES)
        del model
    misses = recs["cpu"]["stats"]["misses"]
    want = attention_only(FK.WGMMA_F16, attn_layers(cfg))
    if len(runs["card"]) != misses or len(runs["cpu"]) != misses or (
            dev.type == "cuda" and any(r["launches"] != want
                                       for r in runs["card"])):
        fail(f"{name}: prefills launched "
             f"{[r['launches'] for r in runs['card']]}, expected {want} "
             f"each for {misses} misses")
    gaps = []
    for a, b in zip(runs["card"], runs["cpu"]):
        got, ref = a["logits"][:cfg.vocab_size].cpu(), b["logits"][
            :cfg.vocab_size]
        gaps.append(float((got - ref).abs().max()))
        if not torch.allclose(got, ref, rtol=F16_TWIN_LOGIT_TOL,
                              atol=F16_TWIN_LOGIT_TOL):
            fail(f"{name}: the card's prefill logits differ from the "
                 f"CPU's by {gaps[-1]} (tolerance {F16_TWIN_LOGIT_TOL})")
    for key in ("cached_tokens", "stats"):
        if recs["card"][key] != recs["cpu"][key]:
            fail(f"{name}: {key} on the card {recs['card'][key]}, on the "
                 f"CPU {recs['cpu'][key]}")
    pairs = [(x, y) for o, p in zip(recs["card"]["outputs"],
                                    recs["cpu"]["outputs"])
             for x, y in zip(o, p)]
    out = {"arch": cfg.name, "dtype": cfg.dtype, "window": window,
           "head_dim": cfg.head_dim, "prefills": misses,
           "cached_tokens": recs["cpu"]["cached_tokens"],
           "logit_max_abs_diff": gaps,
           "outputs_equal": recs["card"]["outputs"] == recs["cpu"]["outputs"],
           "equal_tokens": sum(x == y for x, y in pairs),
           "tokens": len(pairs), "attention_launches": attn}
    print(f"{name}: {json.dumps(out)}", flush=True)
    return out


def f16_phase(seed: int, dev, card: str) -> dict:
    """The f16 models: llama3.2-3b served at full width
    (:func:`f16_serve_phase`), then the f16 TINY twins (``F16_TWINS``,
    :func:`tiny_f16_twin`). Returns their records."""
    rec = {"serve": f16_serve_phase(seed, dev, card), "tiny": {}}
    t0 = time.perf_counter()
    for arch, window, head_dim in F16_TWINS:
        key = arch + (f" window {window}" if window else "") + (
            f" head_dim {head_dim}" if head_dim else "")
        rec["tiny"][key] = tiny_f16_twin(seed, dev, arch, window, head_dim)
    rec["twins_s"] = time.perf_counter() - t0
    print(f"f16 twins ({rec['twins_s']:.1f} s): " + "; ".join(
        f"{k}: logits card - cpu at most {max(r['logit_max_abs_diff']):.3g}"
        f", {r['equal_tokens']} of {r['tokens']} tokens equal"
        for k, r in rec["tiny"].items()) + f"; card {card}", flush=True)
    return rec


def tiny_card_vs_cpu(seed: int, dev, arch: str = "llama32_3b",
                     drained: bool = True, window: int = 0,
                     head_dim: int = 0) -> dict:
    """``arch``'s TINY in f32, the same weights on the card and on the CPU:
    identical outputs, cached prefixes, prefix-cache stats and refcounts,
    first as the serial engine leaves them, then (``drained``) drained
    into the device table (every flash-hash kernel launched on the card).
    Every prefill on the card runs the f32 tensor-core flash-attention
    kernel in each attention layer. ``window`` > 0 serves the twin with that
    sliding window; ``head_dim`` > 0 with heads of that width, and then each
    prefill's last-position logits on the card must also agree with the
    CPU's within ``TWIN_LOGIT_TOL``. Returns the first run's record and its
    flash-attention launches."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models.model import has_ssm
    cfg, models = tiny_models(seed, dev, arch, window, head_dim)
    cpu = torch.device("cpu")
    label = ("tiny" if arch == "llama32_3b" else f"tiny {arch}") + (
        f" window {window}" if window else "") + (
            f" head_dim {head_dim}" if head_dim else "")
    base = TINY_SERVE_SSM if has_ssm(cfg) else TINY_SERVE
    geos = [(label, base)]
    if drained:
        geos.append((f"{label} drained",
                     dict(base, flush_threshold=1, read_pins=True)))
    first = None
    for name, geo in geos:
        runs = {}
        timing = TIMING_STATS if geo.get("flush_threshold") else ()
        logits = {}
        for d in (dev, cpu):
            zero_launches(K.LAUNCHES, FK.LAUNCHES, K.BASELINE_LAUNCHES,
                          FK.SPLIT_LAUNCHES)
            if head_dim:
                logits[d.type] = keep_prefills(models[d.type])
            rec = serve(cfg, models[d.type], d, seed, geo)
            no_baseline(f"serve {name}")
            stats = {k: v for k, v in rec["stats"].items()
                     if k not in timing}
            runs[d.type] = (rec["outputs"], rec["cached_tokens"], stats,
                            rec["held_refs"], rec["refs"])
            if d.type == "cuda":
                launches = dict(K.LAUNCHES)
                attn = dict(FK.LAUNCHES)
                splits = FK.SPLIT_LAUNCHES[FK.TF32X3_SPLIT]
        # every miss prefills the whole prompt
        prefills = rec["stats"]["misses"]
        want = attention_only(FK.TF32X3, prefills * attn_layers(cfg))
        if dev.type == "cuda" and attn != want:
            fail(f"serve {name}: flash-attention launches {attn}, expected "
                 f"{want} ({prefills} f32 prefills x {attn_layers(cfg)} "
                 f"attention layers)")
        # the f32 wide instance launches its pre-pass once a call
        wide = head_dim > FK.NARROW_MAX
        if dev.type == "cuda" and splits != (want[FK.TF32X3] if wide else 0):
            fail(f"serve {name}: {splits} launches of {FK.TF32X3_SPLIT}, "
                 f"expected one a wide f32 launch")
        if runs["cuda"] != runs["cpu"]:
            fail(f"serve {name}: the card and the CPU differ: {runs}")
        if geo.get("flush_threshold") and min(launches.values()) <= 0:
            fail(f"serve {name}: the refcounts never went through a "
                 f"flash-hash kernel on the card: {launches}")
        gap = None
        if head_dim:
            pairs = [(a["logits"].cpu(), b["logits"])
                     for a, b in zip(logits["cuda"], logits["cpu"])]
            gap = max((float((a - b).abs().max()) for a, b in pairs),
                      default=None)
            if len(pairs) != prefills or not all(
                    torch.allclose(a, b, rtol=TWIN_LOGIT_TOL,
                                   atol=TWIN_LOGIT_TOL) for a, b in pairs):
                fail(f"serve {name}: the card's prefill logits are not "
                     f"within {TWIN_LOGIT_TOL} of the CPU's ({prefills} "
                     f"prefills, largest difference {gap})")
        print(f"serve {name} card == cpu: cached {json.dumps(runs['cpu'][1])}"
              f" held refcounts {json.dumps(runs['cpu'][3])} stats "
              f"{json.dumps(runs['cpu'][2])} card launches "
              f"{json.dumps({**launches, **attn})}"
              + (f"; prefill logits card - cpu at most {gap}" if head_dim
                 else ""), flush=True)
        if first is None:
            first = {"arch": cfg.name, "prompt_len": geo["prompt_len"],
                     "outputs_equal": True, "cached_tokens": runs["cpu"][1],
                     "hits": rec["stats"]["hits"],
                     "misses": rec["stats"]["misses"],
                     "attention_launches": attn,
                     "split_launches": splits if dev.type == "cuda" else 0}
            if head_dim:
                first.update(head_dim=head_dim, logit_max_abs_diff=gap)
        else:
            first["drained_launches"] = launches
    return first


def tiny_continuous(seed: int, dev, arch: str = "llama32_3b",
                    drained: bool = True, window: int = 0) -> dict:
    """The continuous run on ``arch``'s TINY twin, on the card and on the
    CPU: identical outputs, cached prefixes, prefix-cache stats and
    refcounts, and the serial engine's outputs; then (``drained``) drained
    into the device table, where every flash-hash kernel must launch on
    the card. Attention stacks replay ``TINY_CONTINUOUS``'s trace on the
    paged path; SSM and hybrid stacks take ``TINY_SSM_CONTINUOUS``'s
    prompts through the whole-prompt fallback. A paged MoE stack routes
    each 16-token chunk with its own expert capacity, so its outputs are
    held to the card's and the CPU's, not to the serial engine's (the
    reference's scheduler departs from its serial engine the same way).
    ``window`` > 0 runs the twin with that sliding window. Returns the
    first run's record."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models.model import has_ssm
    from repro_torch.serving import Request, ServeEngine, make_trace
    cfg, models = tiny_models(seed, dev, arch, window)
    cpu = torch.device("cpu")
    label = ("tiny continuous" if arch == "llama32_3b"
             else f"tiny continuous {arch}") + (
                 f" window {window}" if window else "")
    if has_ssm(cfg):
        geo = TINY_SSM_CONTINUOUS
        prompts = whole_prompt_requests(seed, cfg.vocab_size, geo)
        n_new = [geo["max_new_tokens"]] * len(prompts)
        run = continuous_whole_prompt
    else:
        geo = TINY_CONTINUOUS
        trace = make_trace(**geo["trace"], vocab_size=cfg.vocab_size,
                           seed=seed)
        prompts = [list(t.prompt) for t in trace]
        n_new = [t.max_new_tokens for t in trace]
        run = continuous
    serial = [r.output for r in ServeEngine(cfg, models["cpu"]).serve(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts,
                                                             n_new)])]
    must_equal_serial = has_ssm(cfg) or cfg.num_experts == 0
    geos = [(label, geo)]
    if drained:
        geos.append((f"{label} drained", dict(geo, flush_threshold=1)))
    first = None
    for name, g in geos:
        runs = {}
        for d in (dev, cpu):
            zero_launches(K.LAUNCHES, FK.LAUNCHES, K.BASELINE_LAUNCHES)
            rec = run(cfg, models[d.type], d, seed, g)
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
        equal_serial = runs["cpu"][0] == serial
        if must_equal_serial and not equal_serial:
            fail(f"serve {name}: outputs differ from the serial engine's: "
                 f"{runs['cpu'][0]} against {serial}")
        if g.get("flush_threshold") and min(launches.values()) <= 0:
            fail(f"serve {name}: the refcounts never went through a "
                 f"flash-hash kernel on the card: {launches}")
        print(f"serve {name} card == cpu{' == serial' * equal_serial}: "
              f"cached {json.dumps(runs['cpu'][1])} chunk calls "
              f"{runs['cpu'][4]} decode steps {runs['cpu'][5]} stats "
              f"{json.dumps(runs['cpu'][2])} card launches "
              f"{json.dumps(launches)}", flush=True)
        if first is None:
            first = {"arch": cfg.name, "requests": len(prompts),
                     "outputs_equal": True, "equal_serial": equal_serial,
                     "cached_tokens": runs["cpu"][1],
                     "chunk_calls": runs["cpu"][4],
                     "decode_steps": runs["cpu"][5]}
    return first


# ---------------------------------------------------------------------------
# phases 13-15: the other model families
# ---------------------------------------------------------------------------
def family_serve_phase(seed: int, dev, arch: str, layers=None) -> dict:
    """``arch``'s CONFIG at full width in bf16 (``layers`` of its layers
    kept, or all), random weights from ``seed`` on the card, served as
    the llama3.2-3b phase is (``SERVE``); its flash-attention launches
    are this run's alone: every prefill in every attention layer on the
    tensor-core kernel. The model is freed before it returns."""
    import dataclasses
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t_phase
    params = sum(p.numel() for p in model.parameters())
    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    rec = serve(cfg, model, dev, seed, SERVE, timed=True)
    no_baseline(f"serve {cfg.name}")
    launches = {**FK.LAUNCHES, **K.LAUNCHES}
    prefills = rec["stats"]["misses"]
    want = attention_only(FK.WGMMA, prefills * attn_layers(cfg))
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"serve {cfg.name}: flash-attention launches {got}, expected "
             f"{want} ({prefills} prefills x {attn_layers(cfg)} attention "
             f"layers, all bf16)")
    decode = rec["decode_ms"]
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "layers_of": full_layers, "dtype": cfg.dtype,
           "parameters": params, "init_s": t_init,
           "requests": len(rec["outputs"]),
           "cached_tokens": rec["cached_tokens"],
           "prefill_ms": rec["prefill_ms"], "decode_steps": len(decode),
           "decode_ms_per_token": statistics.median(decode),
           "generated_tokens": rec["tokens"], "wall_s": rec["wall_s"],
           "tokens_per_s": rec["tokens"] / rec["wall_s"],
           "launches": launches, "prefix_cache": rec["stats"],
           "phase_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "decode_ops": decode_ops(model, dev)}
    del model
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve {cfg.name}: {json.dumps(out)}", flush=True)
    return out


def window_prompts(seed: int, vocab: int, geo: dict):
    """``WINDOW_SERVE``'s four prompts: #0 of its own, #1 sharing #0's
    first ``shared`` tokens, #2 and #3 fresh."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, shared = geo["prompt_len"], geo["shared"]
    fresh = lambda k: rng.integers(0, vocab, k).tolist()
    p0 = fresh(n)
    return [p0, p0[:shared] + fresh(n - shared), fresh(n), fresh(n)]


def logit_gap(got, want, vocab: int) -> float:
    """max |got - want| / max |want| over the vocabulary's lanes."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max() / want.abs().max())


def window_serve_phase(seed: int, dev, card: str,
                       geo: dict = WINDOW_SERVE) -> dict:
    """starcoder2-7b at full width in bf16 with its published sliding
    window, random weights from ``seed``, served by ``ServeEngine`` over a
    device ``PrefixKVCache`` (:func:`window_prompts`). Checks outputs,
    cached prefixes ``[0, shared, 0, 0]``, hits, evictions, refcounts,
    nothing dropped, finite logits, and 3 prefills x its layers launches
    of the bf16 tensor-core kernel (no other attention kernel). Then that the
    window reaches decode: #1's first-token logits from the hit path
    (the cached rows decoded under the window) against a fresh windowed
    prefill of #1's prompt, within ``WINDOW_LOGIT_TOL`` of its largest
    logit, and the same hit path with the window taken out of decode
    only (``sliding_window=0`` while the 16 prompt tokens past the prefix
    decode) outside it. Both paths attend over the same keys in bf16 and
    differ only in rounding: the kernel rounds P to bf16 a 64-key tile at
    a time, decode a whole row at once, and the projections of the
    decoded rows round in another batch shape; without the window in
    decode the last 16 positions attend over 8,176 + keys instead of
    4,096, which moves every logit. The model is freed before it
    returns."""
    import dataclasses
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models import model as M
    from repro_torch.serving import PrefixKVCache, Request, ServeEngine
    cfg = dataclasses.replace(get_config(geo["arch"]),
                              sliding_window=geo["window"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    model = M.Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t_phase
    params = sum(p.numel() for p in model.parameters())
    prompts = window_prompts(seed, cfg.vocab_size, geo)
    shared, max_new = geo["shared"], geo["max_new"]
    cache = PrefixKVCache(block_tokens=geo["block_tokens"],
                          capacity_blocks=geo["capacity_blocks"],
                          backend="device", device=dev)
    engine = ServeEngine(cfg, model, prefix_cache=cache)
    first = []                  # each request's first-token logits
    prefill_one = engine._prefill_one

    def keep_first(prompt):
        out = prefill_one(prompt)
        first.append(out[0][0, -1].float().clone())
        return out
    engine._prefill_one = keep_first
    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    with watched(model, ("prefill", "decode_step"), dev, True) as (
            times, finite):
        t0 = time.perf_counter()
        done = engine.serve([Request(prompt=p, max_new_tokens=max_new)
                             for p in prompts])
        wall = time.perf_counter() - t0
    launches = {**FK.LAUNCHES, **K.LAUNCHES}
    no_baseline(f"serve {cfg.name} window")
    outputs = [r.output for r in done]
    cached = [r.cached_tokens for r in done]
    cache._refs.flush()
    stats = cache.stats()
    refs = cache._count(list(cache.store)).tolist()
    cache.close()
    name = f"serve {cfg.name} window {geo['window']}"
    if any(len(o) != max_new or min(o) < 0 or max(o) >= cfg.vocab_size
           for o in outputs):
        fail(f"{name}: outputs are not {max_new} ids below "
             f"{cfg.vocab_size}: {outputs}")
    if cached != [0, shared, 0, 0]:
        fail(f"{name}: cached prefixes {cached}, expected "
             f"{[0, shared, 0, 0]}")
    if (stats["hits"], stats["misses"]) != (1, 3) or stats["evictions"] <= 0:
        fail(f"{name}: hits/misses/evictions {stats}")
    if stats["dropped"] != 0 or any(refs):
        fail(f"{name}: dropped {stats['dropped']}, refcounts after release "
             f"{refs}")
    if not all(bool(f) for f in finite):
        fail(f"{name}: non-finite logits")
    want = attention_only(FK.WGMMA, 3 * attn_layers(cfg))
    if {k: launches[k] for k in want} != want:
        fail(f"{name}: flash-attention launches {launches}, expected "
             f"{want} (3 prefills x {attn_layers(cfg)} layers)")
    # the window reaches decode: the hit path against a fresh prefill,
    # and the hit path with the window out of decode
    tok = lambda p: torch.tensor([p], dtype=torch.int64, device=dev)
    with torch.inference_mode():
        fresh = model.prefill(tok(prompts[1]))[0][0, -1].float()
        _, caches = model.prefill(tok(prompts[0]))
        caches = M.pad_caches(cfg, [type(c)(*(x[:, :, :shared] for x in c))
                                    for c in caches], geo["prompt_len"])
        model.cfg = dataclasses.replace(cfg, sliding_window=0)
        try:
            for i, t in enumerate(prompts[1][shared:]):
                logits, caches = model.decode_step(tok([t]), caches,
                                                   shared + i)
        finally:
            model.cfg = cfg
        del caches
    gap = logit_gap(first[1], fresh, cfg.vocab_size)
    gap_unwindowed = logit_gap(logits[0, -1], fresh, cfg.vocab_size)
    if not (gap <= WINDOW_LOGIT_TOL < gap_unwindowed):
        fail(f"{name}: #1's hit-path logits are {gap:.4g} of the largest "
             f"off a fresh windowed prefill's (at most {WINDOW_LOGIT_TOL}), "
             f"the hit path without the window in decode {gap_unwindowed:.4g}"
             f" (must be above it)")
    decode = times["decode_step"]
    out = {"arch": cfg.name, "window": cfg.sliding_window,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "parameters": params, "init_s": t_init,
           "prompt_len": geo["prompt_len"], "cached_tokens": cached,
           "prefill_ms": times["prefill"], "decode_steps": len(decode),
           "decode_ms_per_token": statistics.median(decode),
           "generated_tokens": sum(map(len, outputs)), "wall_s": wall,
           "tokens_per_s": sum(map(len, outputs)) / wall,
           "hit_logit_gap": gap, "unwindowed_logit_gap": gap_unwindowed,
           "greedy_equal": int(first[1][:cfg.vocab_size].argmax())
           == int(fresh[:cfg.vocab_size].argmax()),
           "launches": launches, "prefix_cache": stats,
           "phase_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "decode_ops": decode_ops(model, dev)}
    del model, logits
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{name}: {json.dumps(out)}", flush=True)
    print(f"{name} ({out['layers']} layers, {params} parameters; {out['phase_s']:.1f} s): prefill ms "
          f"{[round(t, 3) for t in out['prefill_ms']]}, decode "
          f"{out['decode_ms_per_token']:.3f} ms/token (median of "
          f"{len(decode)}; {out['decode_ops']} ops a step), "
          f"{out['tokens_per_s']:.1f} generated tokens/s, peak "
          f"{out['phase_peak_gib']:.2f} GiB; hit path {gap:.4g} of the "
          f"largest logit off a fresh prefill, {gap_unwindowed:.4g} without "
          f"the window in decode; card {card}", flush=True)
    return out


def families_phase(seed: int, dev, card: str) -> dict:
    """The other families: each full-width serve (``FAMILY_SERVES``), the
    windowed starcoder2-7b serve (``WINDOW_SERVE``), each TINY card-vs-CPU
    serial twin (``FAMILY_TWINS``; MLA again drained into the device
    table), each continuous twin (``FAMILY_CONTINUOUS``), and llama32's
    TINY twins with a window (``TINY_WINDOW``), serial and continuous.
    Returns their records."""
    rec = {"serve": {}, "tiny": {}, "tiny_continuous": {}}
    for arch, layers in FAMILY_SERVES:
        r = family_serve_phase(seed, dev, arch, layers)
        rec["serve"][arch] = r
        print(f"serve {r['arch']} ({r['layers']} of {r['layers_of']} "
              f"layers, {r['parameters']} parameters; {r['phase_s']:.1f} "
              f"s): init {r['init_s']:.1f} s, prefill ms "
              f"{[round(t, 3) for t in r['prefill_ms']]}, decode "
              f"{r['decode_ms_per_token']:.3f} ms/token (median of "
              f"{r['decode_steps']}; {r['decode_ops']} ops a step), "
              f"{r['tokens_per_s']:.1f} generated tokens/s, peak "
              f"{r['phase_peak_gib']:.2f} GiB; card {card}",
              flush=True)
    rec["window_serve"] = window_serve_phase(seed, dev, card)
    t0 = time.perf_counter()
    for arch in FAMILY_TWINS:
        rec["tiny"][arch] = tiny_card_vs_cpu(seed, dev, arch,
                                             drained=arch == "minicpm3_4b")
    for arch in FAMILY_CONTINUOUS:
        rec["tiny_continuous"][arch] = tiny_continuous(seed, dev, arch,
                                                       drained=False)
    windowed = f"llama32_3b window {TINY_WINDOW}"
    rec["tiny"][windowed] = tiny_card_vs_cpu(seed, dev, drained=False,
                                             window=TINY_WINDOW)
    narrow = f"llama32_3b head_dim {TINY_HEAD_DIM}"
    rec["tiny"][narrow] = tiny_card_vs_cpu(seed, dev, drained=False,
                                           head_dim=TINY_HEAD_DIM)
    wide = f"llama32_3b head_dim {TINY_WIDE_HEAD_DIM}"
    rec["tiny"][wide] = tiny_card_vs_cpu(seed, dev, drained=False,
                                         head_dim=TINY_WIDE_HEAD_DIM)
    rec["tiny_bf16"] = tiny_bf16_serve(seed, dev)
    rec["tiny_bf16_wide"] = tiny_bf16_serve(seed, dev, "llama32_3b",
                                            TINY_WIDE_HEAD_DIM)
    rec["tiny_continuous"][windowed] = tiny_continuous(
        seed, dev, drained=False, window=TINY_WINDOW)
    rec["twins_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def train_argv(arch: str, steps: int, ckpt_dir: Path, seed: int,
               ckpt_every: int, dev, tiny: bool = False):
    """The train CLI's flags: its own defaults (global batch 8, seq
    128, 2 microbatches, peak lr 3e-3) plus these."""
    return (["--arch", arch, "--steps", str(steps), "--tfidf-filter",
             "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(ckpt_every),
             "--seed", str(seed), "--device", str(dev)]
            + (["--tiny"] if tiny else []))


def train_ops(run) -> int:
    """The aten ops one more train step dispatches, backward and AdamW
    included (a ``TorchDispatchMode``, as ``decode_ops`` counts a decode
    step): the host's work per step. Run after the phase's checks."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    step = run.args.steps
    with Count() as count:
        run.trainer.step_fn(run.state, step)
    run.history.pop()
    return count.n


def step0_check(run, dev) -> dict:
    """Step 0's first microbatch through the built model, before the first
    step: the gradient of every attention projection of every layer (the
    trap of an attention that autograd treats as a constant is a zero
    ``wq`` / ``wk`` / ``wv``), and the variance of the logits over the
    vocabulary. Returns the smallest max-abs gradient of each projection
    and the mean logit variance."""
    import torch
    from repro_torch.data import make_batch
    model = run.state.model
    mb = {k: torch.from_numpy(v[0]).to(dev)
          for k, v in make_batch(run.lcfg, 0).items()}
    names = ("wq", "wk", "wv", "wo")
    leaves = [getattr(blk.mixer, n) for blk in model.layers for n in names]
    with torch.no_grad():
        logits, _, _ = model.forward_train(mb, remat=False)
        var = float(logits[..., :run.cfg.vocab_size].var(-1).mean())
        del logits
    loss, _ = model.loss_fn(mb)
    grads = torch.autograd.grad(loss, leaves)
    amax = torch.stack([g.abs().amax().float() for g in grads]).cpu()
    del grads, loss
    per = amax.reshape(len(model.layers), len(names))
    zero = [(i, names[j]) for i, j in (per == 0).nonzero().tolist()]
    if zero:
        fail(f"train: zero attention gradients on step 0 at {zero}")
    return {"min_attention_grad": {n: float(per[:, j].min())
                                   for j, n in enumerate(names)},
            "logit_var": var}


def train_phase(seed: int, dev, card: str) -> dict:
    """llama3.2-3b at full width in bf16 (random weights from ``seed``)
    trained 8 steps by ``repro_torch.launch.train`` in this process, behind
    the flash-hash TF-IDF filter; no checkpoint is written (a train state
    is 10 bytes a parameter, and the train CLI would save step 0: its
    manager's periodic save is switched off). Checks finite losses and gradient norms,
    step 0's loss within 0.5 of ln(vocab), the last two steps' mean loss
    below step 0's, every attention projection's gradient nonzero on
    step 0, the three hash kernels launched by the filter and no
    flash-attention launch (training attends through ``_sdpa``), 8 steps,
    0 restarts, 0 rollbacks."""
    import math
    import statistics

    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.launch import train
    torch.cuda.synchronize(dev)       # the peak counters need the context
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    workdir = Path(tempfile.mkdtemp(prefix="flash-train-"))
    step0 = {}
    try:
        args = train.parse_args(train_argv("llama32_3b", 8, workdir / "ck",
                                           seed, 1000, dev))
        zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
        def built(r):
            # the train CLI checkpoints step 0 whatever --ckpt-every says
            # (0 % n == 0), as the reference's does: at this width that
            # is 32 GB, so this run's manager saves nothing
            r.trainer.ckpt.maybe_save = lambda *a, **k: False
            step0.update(step0_check(r, dev))

        run = train.run(args, on_built=built)
        no_baseline("train")
        launches = {**K.LAUNCHES, **FK.LAUNCHES}
        hist = run.history
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        cfg = run.cfg
        rep = run.report
        if not all(math.isfinite(x) for x in losses + norms):
            fail(f"train: non-finite loss or grad norm: {hist}")
        # random logits of variance s2 over V lanes cost ln V + s2 / 2
        # in expectation: with tied embeddings drawn N(0, 0.02**2) and a
        # unit-RMS final norm, s2 = 0.02**2 * d = 1.23 at d = 3072
        expect = math.log(cfg.vocab_size) + step0["logit_var"] / 2
        if abs(losses[0] - expect) > 0.5:
            fail(f"train: step 0 loss {losses[0]} is not within 0.5 of "
                 f"ln({cfg.vocab_size}) + var/2 = {expect:.4f} (logit "
                 f"variance {step0['logit_var']:.4f})")
        if statistics.fmean(losses[-2:]) >= losses[0]:
            fail(f"train: the loss did not fall: {losses}")
        if (rep.steps_done, rep.restarts, rep.rollbacks) != (8, 0, 0) or \
                len(hist) != 8:
            fail(f"train: report {rep}, {len(hist)} steps recorded")
        if min(K.LAUNCHES.values()) <= 0:
            fail(f"train: a hash kernel never launched in the filter: "
                 f"{K.LAUNCHES}")
        if any(FK.LAUNCHES.values()):
            fail(f"train: the forward-only flash-attention kernel launched "
                 f"in training: {FK.LAUNCHES}")
        if (workdir / "ck").exists() and any((workdir / "ck").iterdir()):
            fail("train: the full-width phase wrote a checkpoint")
        times = run.trainer.watchdog.times
        step_s = statistics.median(times)
        tokens = args.global_batch * args.seq_len
        params = sum(p.numel() for p in run.state.model.parameters())
        out = {"arch": cfg.name, "layers": cfg.num_layers,
               "dtype": cfg.dtype, "parameters": params,
               "global_batch": args.global_batch, "seq_len": args.seq_len,
               "microbatches": args.microbatches, "steps": rep.steps_done,
               "losses": losses, "grad_norms": norms,
               "lr": [h["lr"] for h in hist], "step_s": times,
               "step_s_median": step_s, "tokens_per_s": tokens / step_s,
               "wall_s": run.wall_s,
               "cli_tokens_per_s": rep.steps_done * tokens / run.wall_s,
               "ln_vocab": math.log(cfg.vocab_size),
               "step0_expected_loss": expect, **step0,
               "launches": launches,
               "stats_tokens": run.stats.tokens_seen,
               "stats_docs": run.stats.docs_seen,
               "phase_peak_gib": torch.cuda.max_memory_allocated(dev)
               / 2 ** 30}
        out["ops_per_step"] = train_ops(run)
        run.close()
        del run
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train {out['arch']}: {json.dumps(out)}", flush=True)
    print(f"train {out['arch']} ({out['layers']} layers, "
          f"{out['parameters']} parameters, bf16; {out['phase_s']:.1f} s): "
          f"median step {out['step_s_median']:.3f} s, "
          f"{out['tokens_per_s']:.0f} tokens/s, {out['ops_per_step']} ops a "
          f"step, peak {out['phase_peak_gib']:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]}; card {card}", flush=True)
    return out


def tiny_train_cfg(arch: str, window: int = 0):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, tiny=True), dtype="float32",
                               sliding_window=window)


def tiny_train(seed: int, dev, arch: str, ckpt_dir: Path, weights,
               window: int = 0) -> dict:
    """``arch``'s TINY in f32 (with a sliding ``window`` if > 0) with
    ``weights`` trained 4 steps by the train CLI on ``dev``, checkpointing
    every 2 steps, with a failure injected at step 3 (a restart from step
    2's checkpoint follows). Returns its report, losses, kept documents
    and corpus counts."""
    import dataclasses

    import numpy as np
    from repro_torch.launch import train
    args = train.parse_args(train_argv(arch, TINY_TRAIN["steps"], ckpt_dir,
                                       seed, TINY_TRAIN["ckpt_every"], dev,
                                       tiny=True))
    run = train.run(args, cfg=tiny_train_cfg(arch, window),
                    on_built=lambda r: r.state.model.load_state_dict(weights),
                    inject_failure_at=TINY_TRAIN["fail_at"])
    keep = run.stats.doc_filter(0.0)
    corpus = run.lcfg.corpus
    rec = {"report": dataclasses.asdict(run.report),
           "losses": [h["loss"] for h in run.history],
           "steps": [h["step"] for h in run.history],
           "kept": [bool(keep(corpus.doc_tokens(i)))
                    for i in range(corpus.num_docs)],
           "counts": run.stats.counts(
               np.arange(run.cfg.vocab_size)).tolist(),
           "stats": [run.stats.tokens_seen, run.stats.docs_seen]}
    run.close()
    return rec


def train_child_command(workdir: Path, seed: int):
    """How the parent starts the restore child: this script again."""
    return [sys.executable, str(Path(__file__).resolve()), "--seed",
            str(seed), "--train-child", str(workdir)]


def train_child(workdir: Path, dev) -> None:
    """A fresh process: resume the llama twin's checkpoints in
    ``workdir / "ck"`` through the train CLI on ``dev`` and train its last
    step; prints the train CLI's lines and the step's loss."""
    from repro_torch.launch import train
    plan = json.loads((workdir / "plan.json").read_text())
    args = train.parse_args(train_argv(
        "llama32_3b", TINY_TRAIN["steps"], workdir / "ck", plan["seed"],
        TINY_TRAIN["ckpt_every"], dev, tiny=True))
    run = train.run(args, cfg=tiny_train_cfg("llama32_3b"))
    print(f"train child: {json.dumps({'start': run.start, 'history': run.history})}",
          flush=True)
    run.close()


def tiny_train_twins(seed: int, dev) -> dict:
    """``TINY_TRAIN_ARCHS`` and ``TINY_TRAIN_WINDOWED`` trained on the
    card and on the CPU with the same weights (``tiny_train``): equal
    reports, losses within 1e-4
    relative (the CPU tests' tolerance for the train step), the same
    kept documents and corpus counts; the llama twin's checkpoint is
    restored by a fresh process on the card, whose step 3 loss must be
    the card run's within 1e-5 relative."""
    import math

    import torch
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.models.model import Model
    cpu = torch.device("cpu")
    out = {}
    workdir = Path(tempfile.mkdtemp(prefix="flash-train-twins-"))
    try:
        twins = ([(arch, arch, 0) for arch in TINY_TRAIN_ARCHS]
                 + [(f"{arch} window {w}", arch, w)
                    for arch, w in TINY_TRAIN_WINDOWED])
        for label, arch, window in twins:
            weights = Model(tiny_train_cfg(arch, window), device=cpu,
                            seed=seed).state_dict()
            runs = {}
            for d in (dev, cpu):
                zero_launches(K.LAUNCHES, K.BASELINE_LAUNCHES)
                runs[d.type] = tiny_train(
                    seed, d, arch, workdir / label.replace(" ", "_") / d.type,
                    weights, window)
                if d.type == "cuda":
                    launches = dict(K.LAUNCHES)
            no_baseline(f"train twin {label}")
            a, b = runs["cuda"], runs["cpu"]
            ra, rb = dict(a["report"]), dict(b["report"])
            la, lb = ra.pop("final_loss"), rb.pop("final_loss")
            ra.pop("stragglers")
            rb.pop("stragglers")
            if ra != rb or ra["restarts"] != 1 or ra["steps_done"] != 4:
                fail(f"train twin {label}: reports differ or are off: "
                     f"{a['report']} / {b['report']}")
            if a["steps"] != b["steps"] or any(
                    not math.isclose(x, y, rel_tol=1e-4)
                    for x, y in zip(a["losses"] + [la], b["losses"] + [lb])):
                fail(f"train twin {label}: losses differ: {a['losses']} / "
                     f"{b['losses']}")
            for k in ("kept", "counts", "stats"):
                if a[k] != b[k]:
                    fail(f"train twin {label}: {k} differ on the card and "
                         f"the CPU")
            if dev.type == "cuda" and min(launches.values()) <= 0:
                fail(f"train twin {label}: a hash kernel never launched on "
                     f"the card: {launches}")
            out[label] = {"report": a["report"], "losses": a["losses"],
                          "cpu_losses": b["losses"], "steps": a["steps"],
                          "kept": sum(a["kept"]), "launches": launches}
            print(f"train twin {label} card == cpu: "
                  f"{json.dumps(out[label])}", flush=True)
        # a fresh process resumes the llama twin's card checkpoints
        child_dir = workdir / "child"
        shutil.copytree(workdir / "llama32_3b" / dev.type, child_dir / "ck")
        (child_dir / "plan.json").write_text(json.dumps({"seed": seed}))
        proc = subprocess.run(train_child_command(child_dir, seed),
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("train child: ")]
        if proc.returncode != 0 or len(lines) != 1:
            fail(f"train child: rc {proc.returncode}\nstdout: "
                 f"{proc.stdout[-2000:]}\nstderr: {proc.stderr[-4000:]}")
        child = json.loads(lines[0].split(": ", 1)[1])
        last = TINY_TRAIN["steps"] - 1
        want = out["llama32_3b"]["losses"][-1]
        got = [h["loss"] for h in child["history"] if h["step"] == last]
        if child["start"] != last or len(got) != 1 or not math.isclose(
                got[0], want, rel_tol=1e-5):
            fail(f"train child: resumed at {child['start']} with "
                 f"{child['history']}, expected step {last} loss {want}")
        out["restore_child"] = {"start": child["start"], "loss": got[0]}
        print(f"train child resumed at step {child['start']}: loss "
              f"{got[0]} (card run {want})", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the mesh phase
# ---------------------------------------------------------------------------
def mesh_dryrun(workdir: Path) -> dict:
    """``MESH_DRYRUN``'s cells traced by ``dryrun.dryrun_cell`` on the host
    (fake tensors over the fake group of 512): per-device dot FLOPs, HBM
    bytes, collective bytes by kind and the reckoned peaks."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape in MESH_DRYRUN:
        rec = dryrun.dryrun_cell(arch, shape, False, workdir, save_hlo=True)
        if not rec["flops"] > 0:
            fail(f"mesh dry-run {arch} {shape}: no dot FLOPs")
        rec["ops_listing"] = ops_listing(
            workdir / f"{arch}__{shape}__16_16.ops.txt")
        coll = {k: v["bytes"] for k, v in rec["collectives"].items()
                if isinstance(v, dict) and v["bytes"]}
        print(f"mesh dry-run {arch} x {shape} x 16x16: plan "
              f"(tp_kv, tp_g, tp_r) = ({rec['plan']['tp_kv']}, "
              f"{rec['plan']['tp_g']}, {rec['plan']['tp_r']}), "
              f"microbatches {rec['plan']['microbatches']}; dot FLOPs "
              f"{rec['flops']:.6e}, HBM bytes upper "
              f"{rec['bytes_accessed_upper']:.6e} / flashproj "
              f"{rec['bytes_accessed_flashproj']:.6e}, collective bytes "
              f"{json.dumps(coll)}, peak {rec['memory']['peak_bytes']} / "
              f"flashproj {rec['memory']['peak_bytes_flashproj']} bytes; "
              f"traced in {rec['trace_s']} s; op listing "
              f"{json.dumps(rec['ops_listing'])}", flush=True)
        out[f"{arch}:{shape}"] = rec
    return out


def ops_listing(path: Path) -> dict:
    """A dry-run op listing (``--save-hlo``): its lines, and their dot
    FLOPs summed (a ``# fb xN`` part N times) against the header's."""
    lines = path.read_text().splitlines()
    head = dict(f.split("=") for f in lines[0].split() if "=" in f)
    total = ops = 0
    times = 1
    for ln in lines[1:]:
        if ln.startswith("#"):
            times = int(ln.split(" x")[1]) if " x" in ln else 1
            continue
        ops += 1
        total += times * int(next(f for f in ln.split("\t")
                                  if f.startswith("flops="))[6:])
    out = {"op_lines": ops, "dot_flops": total, "depth": int(head["depth"]),
           "header_dot_flops": int(head["dot_flops"]), "bytes":
           path.stat().st_size}
    if total != out["header_dot_flops"]:
        fail(f"mesh dry-run listing {path.name}: its lines sum to {total} "
             f"dot FLOPs, the trace to {head['dot_flops']}")
    return out


def rank0_run(shape_name: str, dev, seed: int, rec, opt: bool = False
              ) -> dict:
    """Rank 0's per-device program of llama3.2-3b's ``shape_name`` cell on
    16×16, run for real on the card: the process is rank 0 of the fake
    group, its local shards have the production shapes (random, from
    ``seed``), and collectives complete without moving data (so values
    are not checked here; the TINY twins check them). Run once under the
    op counter (its dot FLOPs must equal the dry-run's exactly) and once
    timed; ``max_memory_allocated`` over both must come within
    ``MESH_PEAK_TOL`` of the dry-run's reckoned peak (flash-projected for
    the prefill, which attends through the kernel). With ``opt``, the
    ``--opt`` program (``dryrun.cell_plan``), held to no dry-run (``rec``
    None)."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.launch.mesh import arch_mesh, make_production_mesh
    from repro_torch.models.config import SHAPES
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import adamw_init
    shape = SHAPES[shape_name]
    cfg, pp, plan = dryrun.cell_plan("llama32_3b", shape, False, opt)
    mesh = arch_mesh(make_production_mesh(device_type="cuda"), plan)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(s, dtype):
        if dtype.is_floating_point:
            return (torch.randn(s, generator=gen, device=dev) * 0.02).to(dtype)
        return torch.randint(0, cfg.vocab_size, s, generator=gen,
                             device=dev, dtype=dtype)

    # the previous run's model and optimizer state go before the peak is
    # reset (DTensor parameters can sit in reference cycles)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mb = pp.microbatches if rec is None else rec["plan"]["microbatches"]
    with steps.sharded(mesh, shd.logical_rules(plan, pp)):
        if shape.kind == "train":
            model = shd.local_model(cfg, mesh,
                                    shd.param_shardings(mesh, cfg, plan, pp),
                                    make)
            model.requires_grad_(True)
            opt_cfg = AdamWConfig(m_dtype="bfloat16" if pp.fsdp
                                  else "float32")
            state = adamw_init(opt_cfg, dict(model.named_parameters()))
            batch = shd.local_tree(ispec.train_specs(cfg, shape, mb), mesh,
                                   shd.batch_shardings(mesh, cfg, plan,
                                                       shape), make)
            step = steps.make_train_step(cfg, opt_cfg, steps.TrainHyper())

            def fn():
                step(model, state, batch)
        else:
            fn = dryrun.programs(cfg, shape, pp, plan, mesh, make)["step"][0]
        local = sum(p.to_local().numel() for p in model.parameters()) \
            if shape.kind == "train" else None
        # the launches of both calls, the counted one and the timed one
        torch.cuda.synchronize(dev)
        zero_launches(FK.LAUNCHES, K.LAUNCHES)
        counted = op_analysis.count(fn, shape.seq_len)
        torch.cuda.synchronize(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize(dev)
    launches = {**FK.LAUNCHES, **K.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"shape": shape_name, "opt": opt, "ms": t0.elapsed_time(t1),
           "dot_flops": counted["dot_flops"],
           "collectives": {k: v["bytes"] for k, v in
                           counted["collectives"].items()
                           if isinstance(v, dict)},
           "all_reduce_by_dtype":
               counted["collectives"]["all-reduce"]["by_dtype"],
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "local_parameters": local, "microbatches": mb}
    if rec is None:
        return out
    # the prefill attends through the kernel (no score tensor), training
    # through the dense _sdpa
    want = rec["memory"]["peak_bytes_flashproj" if shape.kind == "prefill"
                         else "peak_bytes"]
    out.update(dryrun_flops=rec["flops"], dryrun_peak_gib=want / 2 ** 30)
    if counted["dot_flops"] != rec["flops"]:
        fail(f"mesh rank 0 {shape_name}: {counted['dot_flops']} dot FLOPs "
             f"on the card, {rec['flops']} in the dry-run")
    if abs(peak - want) > MESH_PEAK_TOL * want:
        fail(f"mesh rank 0 {shape_name}: peak {peak} bytes on the card, "
             f"{want} reckoned by the dry-run")
    # once a layer in each of the two calls
    want_fa = 2 * cfg.num_layers if shape.kind == "prefill" else 0
    if {k: launches[k] for k in FK.LAUNCHES} != attention_only(
            FK.WGMMA, want_fa) or any(launches[k] for k in K.LAUNCHES):
        fail(f"mesh rank 0 {shape_name}: launches {launches}, expected "
             f"{want_fa} of {FK.WGMMA} and nothing else")
    return out


def mesh_tiny(arch: str, dev, seed: int) -> dict:
    """The CPU tests' simulated 2×4 mesh on the card: ``LocalTensorMode(8)``
    over a fake group of 8 with every rank's shards on ``dev``. TINY f32
    ``arch``, two train steps of two microbatches and a decode step,
    sharded and unsharded on the card and unsharded on the CPU: losses,
    grad norms, updated parameters and decode logits sharded == unsharded
    within 1e-5 (norm-wise, as the tests), card == CPU within 1e-4."""
    import dataclasses

    import numpy as np
    import torch
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod, sharding as shd, steps
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model, init_caches
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import adamw_init
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    sh = ShapeConfig("tiny_train", 64, 8, "train")
    shd_ = ShapeConfig("tiny_dec", 64, 8, "decode")
    hyper = steps.TrainHyper(peak_lr=1e-3, warmup_steps=1, total_steps=100)
    opt_cfg = AdamWConfig(eps=1e-6)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 4, 64)),
                           dtype=torch.int32)

    def whole(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.reconcile() if hasattr(t, "reconcile") else t
        return t.detach().double().cpu()

    def rel(a, b):
        a, b = whole(a), whole(b)
        keep = b.abs() < 1e29
        return float((a - b)[keep].norm() / b[keep].norm().clamp(min=1e-30))

    def run(d, mesh=None, plan=None, pp=None):
        model = Model(cfg, device=d, seed=0)
        model.load_state_dict(weights)
        model.requires_grad_(True)
        batch = {"tokens": toks.to(d), "labels": toks.to(d)}
        caches = init_caches(cfg, 8, 64, torch.float32, device=d)
        ids = torch.arange(8, dtype=torch.int32, device=d)[:, None]
        ctx = contextlib.nullcontext()
        if mesh is not None:
            shd.distribute_model(model, mesh,
                                 shd.param_shardings(mesh, cfg, plan, pp))
            batch = shd.distribute_tree(
                batch, mesh, shd.batch_shardings(mesh, cfg, plan, sh))
            caches = shd.distribute_tree(
                caches, mesh, shd.cache_shardings(mesh, cfg, plan, pp, shd_))
            ids = shd.distribute_tree(
                ids, mesh, shd.placements_from_spec(mesh, ("data", None)))
            ctx = steps.sharded(mesh, shd.logical_rules(plan, pp))
        with ctx:
            step = steps.make_train_step(cfg, opt_cfg, hyper)
            opt = adamw_init(opt_cfg, dict(model.named_parameters()))
            _, opt, m1 = step(model, opt, batch)
            _, opt, m2 = step(model, opt, batch)
            logits, _, _ = steps.make_decode_step(cfg)(model, caches, ids, 3)
        return ([m1, m2], dict(model.named_parameters()), logits)

    weights = Model(cfg, device="cpu", seed=0).state_dict()
    cpu = run(torch.device("cpu"))
    card = run(dev)
    t0 = time.perf_counter()
    with LocalTensorMode(8):
        plan = mesh_mod.plan_for(cfg, model_axis=4)
        mesh = mesh_mod.arch_mesh(mesh_mod.small_mesh(
            (2, 4), ("data", "model"), dev.type), plan)
        pp = shd.ParallelPlan(microbatches=2)
        sharded = run(dev, mesh, plan, pp)
        worst = 0.0
        for a, b in zip(sharded[0], card[0]):
            for key in ("loss", "grad_norm"):
                worst = max(worst, rel(a[key], b[key]))
        for name, prm in sharded[1].items():
            worst = max(worst, rel(prm, card[1][name]))
        worst = max(worst, rel(sharded[2], card[2]))
        losses = [float(whole(m["loss"])) for m in sharded[0]]
    sharded_s = time.perf_counter() - t0
    twin = max([rel(a["loss"], b["loss"]) for a, b in zip(card[0], cpu[0])]
               + [rel(card[2], cpu[2])])
    out = {"arch": cfg.name, "sharded_vs_card_rel": worst,
           "card_vs_cpu_rel": twin, "losses": losses,
           "sharded_s": sharded_s, "mesh": "2x4 (LocalTensorMode)"}
    if worst > 1e-5:
        fail(f"mesh tiny {arch}: sharded vs unsharded on the card {worst}")
    if twin > 1e-4:
        fail(f"mesh tiny {arch}: card vs CPU {twin}")
    return out


def mesh_tiny_bf16_grads(arch: str, dev, seed: int) -> dict:
    """TINY bf16 ``arch``: the weight gradients of two microbatches
    (``steps.accumulate_grads``) sharded on the simulated 2x4 mesh
    against unsharded on the card, each weight's relative error
    (norm-wise); the sharded step sums every data-parallel partial in
    the reference's type (``PERF.md`` §3)."""
    import numpy as np
    import torch
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod, sharding as shd, steps
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model
    cfg = get_config(arch, tiny=True)
    sh = ShapeConfig("tiny_train", 64, 8, "train")
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 4, 64)),
                           dtype=torch.int32)
    weights = Model(cfg, device="cpu", seed=0).state_dict()

    def grads(mesh=None, plan=None, pp=None):
        model = Model(cfg, device=dev, seed=0)
        model.load_state_dict(weights)
        model.requires_grad_(True)
        batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
        ctx = contextlib.nullcontext()
        if mesh is not None:
            shd.distribute_model(model, mesh,
                                 shd.param_shardings(mesh, cfg, plan, pp))
            batch = shd.distribute_tree(
                batch, mesh, shd.batch_shardings(mesh, cfg, plan, sh))
            ctx = steps.sharded(mesh, shd.logical_rules(plan, pp))
        with ctx:
            return steps.accumulate_grads(model, batch)[0]

    def whole(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.reconcile() if hasattr(t, "reconcile") else t
        return t.detach().double().cpu()

    card = grads()
    with LocalTensorMode(8):
        plan = mesh_mod.plan_for(cfg, model_axis=4)
        mesh = mesh_mod.arch_mesh(mesh_mod.small_mesh(
            (2, 4), ("data", "model"), dev.type), plan)
        sharded = grads(mesh, plan, shd.ParallelPlan(microbatches=2))
        rel = {}
        for name, g in sharded.items():
            a, b = whole(g), whole(card[name])
            rel[name] = float((a - b).norm() / b.norm().clamp(min=1e-30))
    worst = max(rel.values())
    out = {"arch": cfg.name, "dtype": cfg.dtype, "grad_rel": rel,
           "worst_grad_rel": worst, "mesh": "2x4 (LocalTensorMode)"}
    if worst > MESH_BF16_GRAD_TOL:
        fail(f"mesh tiny bf16 {arch}: weight gradients sharded vs "
             f"unsharded {worst}")
    return out


def mesh_phase(seed: int, dev, card: str) -> dict:
    """The mesh, sharding and dry-run layer: the dry-run of ``MESH_DRYRUN``,
    rank 0's programs of ``MESH_RUNS`` on the card (``rank0_run``), and the
    TINY sharded twins (``mesh_tiny``). Returns the records and each
    kernel's launches over the whole phase."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_hash import kernel as K
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    dryrun.quiet()
    zero_launches(FK.LAUNCHES, K.LAUNCHES, K.BASELINE_LAUNCHES)
    total = {k: 0 for k in (*FK.LAUNCHES, *K.LAUNCHES)}
    workdir = Path(tempfile.mkdtemp(prefix="flash-mesh-"))
    try:
        dryrun.ensure_world(dryrun.WORLD)
        cells = mesh_dryrun(workdir)
        runs = {}
        for shape in MESH_RUNS:
            r = rank0_run(shape, dev, seed, cells[f"llama32_3b:{shape}"])
            runs[shape] = r
            for k, v in r["launches"].items():
                total[k] += v
            print(f"mesh rank 0 llama3.2-3b {shape} on the card: "
                  f"{r['ms']:.3f} ms a call, dot FLOPs {r['dot_flops']:.6e} "
                  f"(dry-run {r['dryrun_flops']:.6e}), peak "
                  f"{r['peak_gib']:.3f} GiB (dry-run "
                  f"{r['dryrun_peak_gib']:.3f}), all-reduce bytes by dtype "
                  f"{json.dumps(r['all_reduce_by_dtype'])}, launches in the "
                  f"counted and the timed call {json.dumps(r['launches'])}; "
                  f"card {card}",
                  flush=True)
        # the --opt program's train step: its three pet products reduce
        # in bf16, so more of its all-reduce bytes are bf16
        r = rank0_run("train_4k", dev, seed, None, opt=True)
        runs["train_4k_opt"] = r
        for k, v in r["launches"].items():
            total[k] += v
        base = runs["train_4k"]["all_reduce_by_dtype"]
        got = r["all_reduce_by_dtype"]
        print(f"mesh rank 0 llama3.2-3b train_4k --opt on the card: "
              f"{r['ms']:.3f} ms a call (default "
              f"{runs['train_4k']['ms']:.3f}), peak {r['peak_gib']:.3f} GiB "
              f"(default {runs['train_4k']['peak_gib']:.3f}), all-reduce "
              f"bytes by dtype {json.dumps(got)} (default "
              f"{json.dumps(base)}); card {card}", flush=True)
        if not (got.get("bfloat16", 0) > base.get("bfloat16", 0)
                and got.get("float32", 0) < base.get("float32", 0)):
            fail(f"mesh --opt: all-reduce bytes by dtype {got}, default "
                 f"{base}: the pet products did not reduce in bf16")
        if any(r["launches"].values()):
            fail(f"mesh --opt: launches {r['launches']}, expected none")
        dryrun.leave_world()
        dryrun.ensure_world(8)
        tiny = {}
        for arch in MESH_TINY:
            zero_launches(FK.LAUNCHES, K.LAUNCHES)
            tiny[arch] = mesh_tiny(arch, dev, seed)
            for k in total:
                total[k] += {**FK.LAUNCHES, **K.LAUNCHES}[k]
            print(f"mesh tiny {arch}: {json.dumps(tiny[arch])}", flush=True)
        zero_launches(FK.LAUNCHES, K.LAUNCHES)
        tiny["llama32_3b bf16"] = r = mesh_tiny_bf16_grads("llama32_3b",
                                                           dev, seed)
        for k in total:
            total[k] += {**FK.LAUNCHES, **K.LAUNCHES}[k]
        print(f"mesh tiny bf16 llama32_3b: weight gradients sharded vs "
              f"unsharded, worst relative error {r['worst_grad_rel']:.3e} "
              f"{json.dumps(r)}; card {card}", flush=True)
    finally:
        dryrun.leave_world()
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    no_baseline("mesh")
    out = {"dryrun": {k: {f: v[f] for f in (
        "plan", "flops", "bytes_accessed_upper", "bytes_accessed_flashproj",
        "collectives", "memory", "trace_s", "ops_traced", "ops_listing")}
        for k, v in cells.items()},
        "rank0": runs, "tiny": tiny, "launches": total,
        "phase_s": time.perf_counter() - t_phase}
    print(f"mesh phase ({out['phase_s']:.1f} s): launches "
          f"{json.dumps(total)}; card {card}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # the durability phase's child: this script, started by the parent
    ap.add_argument("--durability-child", type=Path, help=argparse.SUPPRESS)
    # a rank of the two-rank sharded phase: this script, started by the
    # parent
    ap.add_argument("--sharded-child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    # the train twins' restore child: this script, started by the parent
    ap.add_argument("--train-child", type=Path, help=argparse.SUPPRESS)
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
    if args.train_child is not None:
        fh_build.LIBRARY.build()
        if fh_build.LIBRARY.last_build["seconds"] != 0.0:
            fail("train child: the flash-hash kernels were rebuilt")
        train_child(args.train_child, dev)
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
    res["merge_dirty_paper_block"] = paper_kernel_case(args.seed, dev)
    attn = attention_phase(args.seed, dev)
    runs = [main_path("MDB-L", FULL, args.seed, dev)]
    for scheme in ("MB", "MDB"):
        runs.append(main_path(scheme, SMALL, args.seed + 1, dev))
    main_run = runs[0]
    paper = paper_block(args.seed, dev)
    wide = wide_card_vs_cpu(args.seed, dev)
    for r in runs + [paper]:
        what = f"{r['scheme']} r_log2={r['r_log2']}"
        print(f"wear {what}: {json.dumps(r['wear'])}")
        print(f"ingest {what}: {r['ingest_tokens_per_s']:.0f} tokens/s;"
              f" lookup: {r['lookup_keys_per_s']:.0f} keys/s")
    race = race_phase(args.seed, dev)
    print(f"race ({race['phase_s']:.1f} s): {race['events']} events "
          f"({race['touched_events']} touched), checker "
          f"{race['checker_s']:.3f} s, no finding; traced "
          f"{race['traced_tokens_per_s']:.0f} tokens/s against the untraced "
          f"twin's {race['untraced_tokens_per_s']:.0f}; launches under the "
          f"tracer {json.dumps(race['launches'])}; seeded "
          f"{json.dumps(race['seeded'])}; card {card}", flush=True)
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
    precision_phase(args.seed, dev, card)
    served, model = serve_phase(args.seed, dev)
    print(f"serve: prefill ms {[round(t, 3) for t in served['prefill_ms']]};"
          f" decode {served['decode_ms_per_token']:.3f} ms/token (median of "
          f"{served['decode_steps']}; {served['decode_ops']} ops a step); "
          f"{served['tokens_per_s']:.1f} generated tokens/s", flush=True)
    cont = continuous_phase(args.seed, dev, model, served["tokens_per_s"])
    del model
    f32 = f32_serve_phase(args.seed, dev, card)
    f16 = f16_phase(args.seed, dev, card)
    print(f"serve continuous ({cont['phase_s']:.1f} s): {cont['ticks']} "
          f"ticks, chunk {cont['chunk_ms_median']:.3f} ms, packed decode "
          f"{cont['decode_ms_median']:.3f} ms (medians); "
          f"{cont['tokens_per_s']:.1f} generated tokens/s against the "
          f"serial engine's {served['tokens_per_s']:.1f}; card {card}",
          flush=True)
    twin = tiny_card_vs_cpu(args.seed, dev)
    tiny_continuous(args.seed, dev)
    torch.cuda.empty_cache()
    fam = families_phase(args.seed, dev, card)
    trained = train_phase(args.seed, dev, card)
    twins = tiny_train_twins(args.seed, dev)
    mesh = mesh_phase(args.seed, dev, card)
    window_serve = fam["window_serve"]["launches"]
    tiny_bf16 = fam["tiny_bf16"]["attention_launches"][FK.WGMMA]
    tiny_bf16_wide = fam["tiny_bf16_wide"]["attention_launches"][FK.WGMMA]
    wgmma = served["launches"][FK.WGMMA] + sum(
        r["launches"][FK.WGMMA] for r in fam["serve"].values()) + (
            window_serve[FK.WGMMA]) + tiny_bf16 + tiny_bf16_wide
    twin_f32 = twin["attention_launches"][FK.TF32X3] + sum(
        r["attention_launches"][FK.TF32X3] for r in fam["tiny"].values())
    kernels = []
    for name in K.LAUNCHES:
        # the lookup kernels at the layout the path launches them on
        r = res.get(f"{name}_path", res[name])
        kernels.append({
            "name": name, "route": "cuda", "source": CU,
            "replaces": REPLACES[name],
            "launches": main_run["launches"][name],
            "race_launches": race["launches"][name],
            "train_launches": trained["launches"][name],
            "mesh_launches": mesh["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # the merge's other two routes, each timed at the paper's block: the
    # cluster fold (2**14 to 2**17 slots; its launches on the paper_block
    # path, and the card-against-CPU stores' at 65,536 slots) and, in turns
    # with it, the in-place fold (every other width; its launches in the
    # card-against-CPU stores at 1 and 4 slots, the paper_block path's 0)
    r = res["merge_dirty_paper_block"]
    shape = {k: r[k] for k in ("q_log2", "r_log2", "n_d", "max_u",
                               "updates")}
    wide_routes = [v["merge_routes"] for k, v in wide.items()
                   if k != "phase_s"]
    for route, prefix in (("cluster", ""), ("in_place", "in_place_")):
        kernels.append({
            "name": f"merge_dirty_{route}", "route": "cuda", "source": CU,
            "replaces": REPLACES["merge_dirty"],
            "launches": (paper["merge_routes"][route] if route == "cluster"
                         else sum(w[route] for w in wide_routes)),
            "paper_block_launches": paper["merge_routes"][route],
            "wide_card_vs_cpu_launches": sum(w[route] for w in wide_routes),
            "max_abs_err": r[prefix + "max_abs_err"],
            "ms": r[prefix + "ms"], "device_ms": r[prefix + "device_ms"],
            **({"wrapper_ms": r["wrapper_ms"],
                "plan": r["cluster_plan"]} if route == "cluster" else {}),
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "shape": shape,
            "serial_skipped": r.get("serial_skipped")})
    # each flash-attention kernel at the shape of the path that runs it:
    # bf16, the serve prefill, launched by every family's serve and the
    # bf16 starcoder2 TINY serve, and with a window starcoder2-7b's serve;
    # f32, the f32 serve's 512-token prefill, launched by the f32 serve (its
    # 4,096-token prefill too) and every f32 twin, and with a window the
    # windowed f32 twin. Beside each, its case whose rows are no multiple of
    # 16 bytes (loaded without TMA) and the path that launched it there:
    # ``bf16_d12`` and the bf16 starcoder2 TINY serve; ``f32_d6`` and the
    # f32 twin with heads of 6
    window_twin = fam["tiny"][f"llama32_3b window {TINY_WINDOW}"]
    narrow_twin = fam["tiny"][f"llama32_3b head_dim {TINY_HEAD_DIM}"]
    wide_twin = fam["tiny"][f"llama32_3b head_dim {TINY_WIDE_HEAD_DIM}"]
    # each kernel's wide instance (heads over 256): the paths that launched
    # it (the TINY twins with heads of 320) and each of its cases
    # the f16 instance: the f16 serve and its TINY twins (starcoder2's
    # windowed twin, heads of 12, is both its windowed and its odd path;
    # llama32's with heads of 320 its wide one)
    f16_twin = sum(r["attention_launches"][FK.WGMMA_F16]
                   for r in f16["tiny"].values())
    f16_window = f16["tiny"][f"starcoder2_7b window {TINY_WINDOW}"][
        "attention_launches"][FK.WGMMA_F16]
    wide_launches = {FK.WGMMA: tiny_bf16_wide,
                     FK.TF32X3: wide_twin["attention_launches"][FK.TF32X3],
                     FK.WGMMA_F16: f16["tiny"][
                         f"llama32_3b head_dim {TINY_WIDE_HEAD_DIM}"][
                         "attention_launches"][FK.WGMMA_F16]}
    wide_keys = ("shape", "loads", "plan", "max_abs_err", "ms", "device_ms",
                 "plain_ms", "bound_ms", "bound_by", "device_bound_share",
                 "library_ms", "library_device_ms", "library_ratio",
                 "split_device_ms")
    for name, case, launches, w_case, w_launches, o_case, o_launches, \
            extra in (
            (FK.WGMMA, "serve", wgmma, "starcoder2_window",
             window_serve[FK.WGMMA], "bf16_d12", tiny_bf16,
             {"odd_window_max_abs_err":
                  attn["bf16_d12_window"]["max_abs_err"],
              "odd_window_device_ms": attn["bf16_d12_window"]["device_ms"],
              "ragged_odd_max_abs_err": attn["bf16_odd"]["max_abs_err"],
              "ragged_odd_device_ms": attn["bf16_odd"]["device_ms"],
              "ragged_odd_library_device_ms":
                  attn["bf16_odd"]["library_device_ms"]}),
            (FK.TF32X3, "f32",
             f32["launches"][FK.TF32X3] + twin_f32, "tiny_f32_window",
             window_twin["attention_launches"][FK.TF32X3], "f32_d6",
             narrow_twin["attention_launches"][FK.TF32X3],
             {"f32_serve_launches": f32["launches"][FK.TF32X3],
              "twin_launches": twin_f32,
              "long_device_ms": attn["f32_long"]["device_ms"],
              "long_library_device_ms":
                  attn["f32_long"]["library_device_ms"],
              "long_bound_ms": attn["f32_long"]["bound_ms"],
              "tiny_device_ms": attn["tiny_f32"]["device_ms"],
              "f32_serve_logit_gap": max(f32["logit_gaps"])}),
            (FK.WGMMA_F16, "f16",
             f16["serve"]["launches"][FK.WGMMA_F16] + f16_twin,
             "f16_starcoder2_window", f16_window, "f16_d12", f16_window,
             {"f16_serve_launches": f16["serve"]["launches"][FK.WGMMA_F16],
              "twin_launches": f16_twin,
              "long_device_ms": attn["f16_long"]["device_ms"],
              "long_library_device_ms":
                  attn["f16_long"]["library_device_ms"],
              "long_bound_ms": attn["f16_long"]["bound_ms"],
              "f16_serve_logit_gap": max(f16["serve"]["logit_gaps"]),
              "f16_serve_greedy_equal": f16["serve"]["greedy_equal"],
              "twin_logit_gap": max(max(r["logit_max_abs_diff"])
                                    for r in f16["tiny"].values())})):
        r, rw, ro = attn[case], attn[w_case], attn[o_case]
        kernels.append({
            "name": name, "route": "cuda", "source": FA_CU,
            "replaces": REPLACES["flash_attention"], "launches": launches,
            "race_launches": race["launches"][name],
            "train_launches": trained["launches"][name],
            "mesh_launches": mesh["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"],
            "window_launches": w_launches,
            "window_max_abs_err": rw["max_abs_err"],
            "window_device_ms": rw["device_ms"],
            "window_bound_ms": rw["bound_ms"],
            "window_library_ms": rw["library_ms"],
            "odd_case": o_case, "odd_heads": ro["shape"][2:],
            "odd_launches": o_launches,
            "odd_max_abs_err": ro["max_abs_err"], "odd_ms": ro["ms"],
            "odd_device_ms": ro["device_ms"], "odd_plain_ms": ro["plain_ms"],
            "odd_bound_ms": ro["bound_ms"], "odd_bound_by": ro["bound_by"],
            "odd_library_ms": ro["library_ms"],
            "odd_library_device_ms": ro["library_device_ms"],
            "wide_launches": wide_launches[name],
            "wide_cases": {c: {**{key: attn[c].get(key) for key in wide_keys},
                               "library_kernels": list(attn[c].get(
                                   "library_kernels", {}))[:3]}
                           for c in WIDE_CASES[name]}, **extra})
    # the f32 wide instance's pre-pass: launched once with each wide f32
    # call (the f32 TINY twin with heads of 320), timed alone at wide_f32's
    # shape and held bit for bit to its plain version
    r = attn["tf32_split"]
    kernels.append({
        "name": FK.TF32X3_SPLIT, "route": "cuda", "source": FA_CU,
        "replaces": REPLACES["flash_attention"],
        "launches": wide_twin["split_launches"], "shape": r["shape"],
        "max_abs_err": r["max_abs_err"], "mismatches": r["mismatches"],
        "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None})
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"families": fam}))
    print(json.dumps({"f16": {"serve": {k: v for k, v in f16["serve"].items()
                                        if k != "launches"},
                              "tiny": f16["tiny"]}}))
    print(json.dumps({"train": {"llama32_3b": trained, "twins": twins}}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
