"""Continuous-batching scheduler over a packed slot table.

Replaces the serial ``ServeEngine.serve`` loop with iteration-level
scheduling: a fixed table of ``max_slots`` decode slots, each at its own
sequence position, advanced by one :meth:`Model.decode_step_packed` per
tick. Requests join a free slot mid-flight, prefill in fixed-size chunks
*interleaved* with decode ticks, and leave the moment they finish: no
batch barrier.

Prefill is paged: the chunk size is the prefix cache's block size, chunks
cover absolute aligned windows ``[k·B, (k+1)·B)`` and are padded to that
fixed shape with token 0 (the causal mask hides the padding rows and
later decode writes overwrite them). That alignment makes every chunk
without padding the same cache segment any other request would compute
for the same token chain, so such chunks go straight into the
:class:`~.prefix_cache.PrefixKVCache` block pool (``insert_block``) and
cached prefixes come straight back out (``acquire_blocks``, then one row
copy per block). The counting flash-hash refcounts pin each block for
the lifetime of the requests using it.

The slot caches (``model.init_caches`` over ``max_slots`` rows of
``max_context + 1`` positions: K/V or MLA's latent and roped key, or an
SSM's conv tail and state, each stacked over the groups) live on the
model's device and are written in place: a chunk runs on views of its own
slot's rows, so the other slots are untouched; a packed decode writes one
row per slot. A pooled block is a copy (fresh storage that no later
decode or chunk can reach), and a pinned block is copied into a slot's
rows, never aliased. A tick syncs the host once per packed decode (the
argmax of every row) and once per finished prefill, as the reference
does; token and index tensors reach the card by asynchronous copies.

SSM / hybrid stacks cannot enter a recurrent state mid-sequence, so they
take the reference's whole-prompt fallback: the prompt is prefilled at
its exact length (frontend stub embeddings included), its caches padded
to the slot's rows and copied into them, and no chunk, block pool or
prefix lookup is used. Packed decode is unchanged: SSM decode is
position-free.

This module is the one serving file allowed to use ``threading``
(flashlint FL004): :func:`replay_trace` replays an arrival-timed trace
through feeder threads while the calling thread turns the scheduler
crank. ``submit`` is the only cross-thread entry point and is
lock-protected; all tensor work stays on the cranking thread.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import model as M
from ..models.config import ModelConfig
from .block_pool import NUM_TOKENS_IN_BLOCK
from .prefix_cache import PrefixKVCache


@dataclasses.dataclass
class SchedRequest:
    """One request's lifecycle: waiting → prefill → decode → done."""
    prompt: List[int]
    max_new_tokens: int = 16
    request_id: int = -1
    output: List[int] = dataclasses.field(default_factory=list)
    cached_tokens: int = 0
    pinned: List[int] = dataclasses.field(default_factory=list)
    submit_s: float = 0.0
    start_s: float = 0.0
    finish_s: float = 0.0
    # scheduler-internal
    slot: int = -1
    phase: str = "waiting"
    done: int = 0        # prompt tokens whose KV already sits in the slot

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.submit_s


class ContinuousBatchingScheduler:
    def __init__(self, cfg: ModelConfig, model: M.Model,
                 prefix_cache: Optional[PrefixKVCache] = None,
                 max_slots: int = 4, max_context: int = 192,
                 prefill_chunks_per_tick: int = 1):
        # a device table of refcounts must share the model's device; the
        # sim's refcounts live on the host beside any model
        if prefix_cache is not None and prefix_cache.refs is not None:
            refs_dev = prefix_cache.refs.keys.device
            if refs_dev != model.device:
                raise ValueError(f"the prefix cache's refcounts are on "
                                 f"{refs_dev}, the model on {model.device}")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.cache = prefix_cache
        self.max_slots = max_slots
        self.max_context = max_context
        self.prefill_chunks_per_tick = prefill_chunks_per_tick
        self.bt = (prefix_cache.block_tokens if prefix_cache is not None
                   else NUM_TOKENS_IN_BLOCK)
        self._ssm = M.has_ssm(cfg)
        # slot rows run 0..max_context-1; row max_context is a scratch row
        # where idle slots "decode" a dummy token each tick (never attended
        # to: every real query position is < max_context)
        self.park = max_context
        self.s_max = max_context + 1
        self.caches = M.init_caches(cfg, max_slots, self.s_max, model.dtype,
                                    device=self.device)

        self._lock = threading.Lock()
        self._waiting: collections.deque = collections.deque()
        self._active: List[Optional[SchedRequest]] = [None] * max_slots
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self.completed: List[SchedRequest] = []
        self.decode_steps = 0
        self.chunk_calls = 0

    # -- submission (the one cross-thread entry point) -----------------------
    def submit(self, req: SchedRequest) -> SchedRequest:
        if len(req.prompt) + req.max_new_tokens > self.max_context:
            raise ValueError(
                f"request needs {len(req.prompt) + req.max_new_tokens} "
                f"rows > max_context={self.max_context}")
        padded = -(-len(req.prompt) // self.bt) * self.bt
        if not self._ssm and padded > self.s_max:
            # the last chunk's padding would run past the cache (the
            # reference clamps that chunk onto earlier rows)
            raise ValueError(
                f"a {len(req.prompt)}-token prompt pads to {padded} rows > "
                f"max_context={self.max_context} + 1 cache rows")
        req.submit_s = time.monotonic()
        with self._lock:
            self._waiting.append(req)
        return req

    # -- device helpers ------------------------------------------------------
    def _tensor(self, ints) -> torch.Tensor:
        """Host ints → an int64 tensor on the scheduler's device; on the
        card by an asynchronous copy from pinned memory (no host sync)."""
        t = torch.as_tensor(np.asarray(ints, np.int64))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _row(self, slot: int) -> list:
        """Views of one slot's caches, every tensor (groups, 1, ...)."""
        return [type(c)(*(x[:, slot:slot + 1] for x in c))
                for c in self.caches]

    def _read_block(self, slot: int, start: int) -> list:
        """A copy of one slot's rows ``[start, start+B)``: fresh storage,
        so the pooled segment never changes when the slot is reused."""
        return [type(c)(*(x[:, :, start:start + self.bt].clone()
                          for x in c)) for c in self._row(slot)]

    def _write_block(self, seg: list, slot: int, start: int) -> None:
        """Copy a pooled segment into one slot's rows ``[start, start+B)``."""
        for c, s in zip(self._row(slot), seg):
            for x, y in zip(c, s):
                x[:, :, start:start + self.bt].copy_(y)

    # -- admission -----------------------------------------------------------
    def _admit(self) -> None:
        while self._free_slots:
            with self._lock:
                if not self._waiting:
                    return
                req = self._waiting.popleft()
            slot = self._free_slots.pop()
            req.slot = slot
            req.start_s = time.monotonic()
            if self._ssm:
                self._admit_whole_prompt(req)
            else:
                self._admit_paged(req)
            self._active[slot] = req

    def _admit_paged(self, req: SchedRequest) -> None:
        """Reuse cached prefix blocks: copy each pinned segment into the
        slot's rows, then chunk-prefill only the remainder."""
        n = 0
        if self.cache is not None:
            n, values, req.pinned = self.cache.acquire_blocks(req.prompt)
            for j, seg in enumerate(values):
                self._write_block(seg, req.slot, j * self.bt)
        req.cached_tokens = n
        req.done = n
        # n == len(prompt) (exact full-prompt hit) goes straight to decode
        # with an empty output; the first decode tick re-decodes the final
        # prompt token at its own position to recover first-token logits
        req.phase = "prefill" if n < len(req.prompt) else "decode"

    def _admit_whole_prompt(self, req: SchedRequest) -> None:
        """SSM / hybrid fallback: prefill the whole prompt at its exact
        length and copy its caches, padded to the slot's rows, into the
        slot."""
        tokens = self._tensor([req.prompt])
        logits, row = self.model.prefill(
            tokens, M.zero_frontend_embeds(self.cfg, self.model))
        row = M.pad_caches(self.cfg, row, self.s_max)
        for c, r in zip(self._row(req.slot), row):
            for x, y in zip(c, r):
                x.copy_(y)
        req.done = len(req.prompt)
        req.output.append(
            int(torch.argmax(logits[0, -1, :self.cfg.vocab_size])))
        req.phase = "decode"

    # -- chunked prefill ------------------------------------------------------
    def _prefill_one_chunk(self, req: SchedRequest) -> None:
        P = len(req.prompt)
        k = req.done // self.bt
        start = k * self.bt
        toks = req.prompt[start:start + self.bt]
        pad = self.bt - len(toks)
        logits, _ = self.model.prefill_chunk(
            self._tensor([toks + [0] * pad]), self._row(req.slot), start)
        self.chunk_calls += 1
        req.done = min(start + self.bt, P)
        if self.cache is not None and pad == 0:
            # a chunk without padding IS a cache block: copy its rows out
            # and register them (pinning the new block for this request)
            key = self.cache.insert_block(req.prompt, k,
                                          self._read_block(req.slot, start))
            if key is not None:
                req.pinned.append(key)
        if req.done >= P:
            off = (P - 1) - start
            req.output.append(
                int(torch.argmax(logits[0, off, :self.cfg.vocab_size])))
            req.phase = "decode"

    def _prefill_tick(self) -> bool:
        budget = self.prefill_chunks_per_tick
        did = False
        for req in self._active:
            if budget <= 0:
                break
            if req is None or req.phase != "prefill":
                continue
            self._prefill_one_chunk(req)
            did = True
            budget -= 1
        return did

    # -- packed decode --------------------------------------------------------
    def _decode_tick(self) -> bool:
        rows = [r for r in self._active
                if r is not None and r.phase == "decode"]
        if not rows:
            return False
        toks = np.zeros((self.max_slots, 1), np.int64)
        idx = np.full((self.max_slots,), self.park, np.int64)
        for req in rows:
            P = len(req.prompt)
            if req.output:
                toks[req.slot, 0] = req.output[-1]
                idx[req.slot] = P + len(req.output) - 1
            else:  # full-prompt cache hit: re-decode the last prompt token
                toks[req.slot, 0] = req.prompt[-1]
                idx[req.slot] = P - 1
        logits, _ = self.model.decode_step_packed(
            self._tensor(toks), self.caches, self._tensor(idx))
        self.decode_steps += 1
        out = torch.argmax(logits[:, -1, :self.cfg.vocab_size],
                           dim=-1).tolist()
        for req in rows:
            req.output.append(out[req.slot])
            if len(req.output) >= req.max_new_tokens:
                self._finish(req)
        return True

    def _finish(self, req: SchedRequest) -> None:
        req.phase = "done"
        req.finish_s = time.monotonic()
        if self.cache is not None:
            self.cache.release(req.pinned)
        self._active[req.slot] = None
        self._free_slots.append(req.slot)
        req.slot = -1
        self.completed.append(req)

    # -- crank ----------------------------------------------------------------
    def step(self) -> bool:
        """One tick: admit, advance prefill by up to
        ``prefill_chunks_per_tick`` chunks, one packed decode step."""
        with torch.inference_mode():
            self._admit()
            did = self._prefill_tick()
            if self._decode_tick():
                did = True
        return did

    def run(self, requests: Optional[Sequence[SchedRequest]] = None
            ) -> List[SchedRequest]:
        """Drain: submit ``requests`` (if given) and tick until idle."""
        if requests is not None:
            for r in requests:
                self.submit(r)
        while True:
            did = self.step()
            with self._lock:
                empty = not self._waiting
            if not did and empty and all(r is None for r in self._active):
                return self.completed


# ---------------------------------------------------------------------------
# trace replay (queue + worker feeder threads)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceReport:
    requests: int
    generated_tokens: int
    wall_s: float
    tokens_per_s: float
    p50_latency_s: float
    p99_latency_s: float
    hit_rate: float          # token-level prefix-cache hit rate
    wear: int                # accounted flash wear (tile_stores / cleans)

    def summary(self) -> str:
        return (f"fig7dev: n={self.requests} "
                f"tok/s={self.tokens_per_s:.1f} "
                f"p50={self.p50_latency_s * 1e3:.1f}ms "
                f"p99={self.p99_latency_s * 1e3:.1f}ms "
                f"hit_rate={self.hit_rate:.3f} wear={self.wear}")


def replay_trace(sched: ContinuousBatchingScheduler, trace,
                 workers: int = 2, time_scale: float = 0.0) -> TraceReport:
    """Replay an arrival-timed trace through feeder worker threads.

    Trace items need ``prompt``/``max_new_tokens``/``arrival_s``
    (see :mod:`.trace`). Items are sharded round-robin over ``workers``
    threads which sleep until each item's (scaled) arrival time and
    ``submit`` it; the calling thread turns the scheduler crank until
    every request completes. ``time_scale=0`` replays as fast as the
    queue drains (offline / throughput mode)."""
    reqs = [SchedRequest(prompt=list(it.prompt),
                         max_new_tokens=it.max_new_tokens, request_id=i)
            for i, it in enumerate(trace)]
    t0 = time.monotonic()

    def feeder(items):
        for arrival, req in items:
            if time_scale > 0:
                delay = t0 + arrival * time_scale - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            sched.submit(req)

    shards: List[list] = [[] for _ in range(max(1, workers))]
    for i, (it, req) in enumerate(zip(trace, reqs)):
        shards[i % len(shards)].append((getattr(it, "arrival_s", 0.0), req))
    threads = [threading.Thread(target=feeder, args=(s,), daemon=True)
               for s in shards if s]
    for th in threads:
        th.start()
    # count only this replay's requests: the scheduler may already have
    # completions from warmup or earlier traces
    while any(r.phase != "done" for r in reqs):
        if not sched.step():
            time.sleep(0.001)
    for th in threads:
        th.join()
    wall = time.monotonic() - t0

    lats = np.asarray([r.latency_s for r in reqs])
    gen = sum(len(r.output) for r in reqs)
    prompt_toks = sum(len(r.prompt) for r in reqs)
    cached = sum(r.cached_tokens for r in reqs)
    wear = 0
    if sched.cache is not None:
        w = sched.cache._refs.wear()
        wear = int(w.get("tile_stores", w.get("cleans", 0)))
    return TraceReport(
        requests=len(reqs), generated_tokens=gen, wall_s=wall,
        tokens_per_s=gen / max(wall, 1e-9),
        p50_latency_s=float(np.percentile(lats, 50)) if len(lats) else 0.0,
        p99_latency_s=float(np.percentile(lats, 99)) if len(lats) else 0.0,
        hit_rate=cached / max(prompt_toks, 1),
        wear=wear)
