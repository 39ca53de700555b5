"""Host-side batched write engine for the device flash-hash table.

The paper's insert/update axis (§2.2, Figure 4) is won by buffering and
batching writes *before* they reach the device: the RAM buffer H_R
absorbs and dedups the raw token stream, and only threshold-triggered
flushes touch flash. This engine is the write twin of
:class:`.query_engine.BatchedQueryEngine`, the front door every writer
(TF-IDF ingest, corpus stats) goes through instead of calling
``table_torch.update`` per raw batch:

* **host-side H_R** — a token→Δ dict accumulates (and dedups) incoming
  batches; Δs that cancel to zero drop out (paper §2.6);
* **threshold-triggered flushes** — the device sees traffic only when
  the buffer reaches ``flush_threshold`` unique entries (or on an
  explicit :meth:`flush`/:meth:`merge`), in sorted, deterministic order;
* **fixed-shape padded chunks** — flushed entries are EMPTY-padded up
  to ``chunk``;
* **in-place updates** — dispatches go through ``table_torch.update`` /
  ``flush``, which consume the state and rewrite its tensors in place;
* **automatic invalidation** — a paired query engine is invalidated on
  every flush *by the engine*; reads through :meth:`query_batch` overlay
  the buffered (unflushed) Δs, so writers read their own writes;
* **double-buffered async flush** — with a store-owned dispatcher
  attached, :meth:`flush` *seals* H_R and hands the sealed chunk to a
  background worker while ingest fills a fresh buffer; reads overlay
  both buffers. A completed drain synchronises the device stream, so it
  means the device really holds the entries;
* **ledger** — :class:`WriteEngineStats` counts buffered / deduped /
  dispatched entries and flush events, plus ``overlap_us`` (drain time
  hidden behind ingest) and ``stall_us`` (time ingest waited on a drain).

Unlike the (state-free) query engine, this engine *owns* the device
state: ``engine.state`` is the current ``DeviceTableState``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class WriteEngineStats:
    """Write-path counters, the H_R-side ledger that complements the
    device ``TableStats`` wear counters."""

    updates: int = 0             # update() calls (writer-side batches)
    entries: int = 0             # valid (token, Δ) entries received
    buffered: int = 0            # entries that opened a new H_R slot
    deduped: int = 0             # entries absorbed without opening a
                                 # slot (duplicates + cancellations);
                                 # entries == buffered + deduped
    cancelled: int = 0           # Δ sums that hit zero in H_R (§2.6)
    dispatched_entries: int = 0  # unique (token, Δ) pairs sent to device
    dispatches: int = 0          # update dispatches (chunks)
    flushes: int = 0             # H_R drain events (explicit + auto)
    auto_flushes: int = 0        # threshold-triggered drains
    merges: int = 0              # device-merge (table flush) requests
    invalidations: int = 0       # query-engine invalidations driven
    overlap_us: int = 0          # drain time hidden behind ingest (async)
    stall_us: int = 0            # ingest time blocked on a drain: the
                                 # whole drain when synchronous, only the
                                 # double-buffer waits when async

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def dedup_batch(tokens, deltas, empty: int):
    """Validate and pre-fold one raw writer batch: flatten, drop ``empty``
    padding, and collapse duplicate tokens to (unique, Δ-sum) pairs.

    Returns ``(uniq, sums, n_valid)``."""
    flat = np.asarray(tokens).reshape(-1).astype(np.int64)
    if deltas is None:
        d = np.ones(flat.size, np.int64)
    else:
        d = np.asarray(deltas).reshape(-1).astype(np.int64)
        if d.size != flat.size:
            raise ValueError(f"deltas size {d.size} != tokens {flat.size}")
    valid = flat != empty
    n_valid = int(valid.sum())
    if n_valid == 0:
        return (np.zeros(0, np.int64),) * 2 + (0,)
    uniq, inv = np.unique(flat[valid], return_inverse=True)
    sums = np.zeros(uniq.size, np.int64)
    np.add.at(sums, inv, d[valid])
    return uniq, sums, n_valid


def fold_entry(buf: Dict[int, int], k: int, s: int) -> int:
    """Fold one (token, Δ-sum) into an H_R dict with the paper's §2.6
    semantics: duplicates accumulate, sums that hit zero drop out (never
    retained in memory). Returns +1 if a new slot opened, 0 if it folded
    into an existing slot, −1 if it cancelled (ledger: buffered /
    deduped / cancelled respectively)."""
    cur = buf.get(k)
    if cur is None:
        if s:
            buf[k] = s
            return 1
        return -1
    if cur + s:
        buf[k] = cur + s
        return 0
    del buf[k]
    return -1


class PartitionHeatLedger:
    """Per-partition write-pressure ledger of the wear-tracking backend:
    a staged-since-last-merge histogram plus a decayed per-merge heat
    history.

    ``note(parts_counts, wear_delta)`` is the single mutation point —
    callers hold their dispatcher lock (the backend feeds it from
    ``_on_drain`` on the drain worker). Staged entries accumulate per
    partition; a positive ``wear_delta`` halves the existing heat and
    charges the delta to the staged partitions proportional to volume
    (recent merge pressure, not lifetime totals); ``parts_counts=None``
    marks a forced merge and clears the staged histogram after charging.
    Partition ids are caller-defined (change-segment partitions for MDB,
    data blocks otherwise).
    """

    def __init__(self) -> None:
        self.heat: Dict[int, float] = {}
        self.staged: Dict[int, int] = {}

    def note(self, parts_counts, wear_delta: float) -> None:
        if parts_counts is not None:
            for p, c in parts_counts:
                self.staged[int(p)] = self.staged.get(int(p), 0) + int(c)
        if wear_delta > 0 and self.staged:
            self.heat = {p: 0.5 * v for p, v in self.heat.items()}
            total = sum(self.staged.values())
            for p, c in self.staged.items():
                self.heat[p] = self.heat.get(p, 0.0) + wear_delta * c / total
        if parts_counts is None:
            self.staged.clear()

    def snapshot(self) -> Tuple[Dict[int, int], Dict[int, float]]:
        """Copies of (staged, heat) — take under the caller's lock, then
        combine with live-buffer pendings lock-free."""
        return dict(self.staged), dict(self.heat)

    def clear(self) -> None:
        self.heat.clear()
        self.staged.clear()


class BatchedWriteEngine:
    """H_R dedup + threshold flush + fixed-shape in-place dispatch over
    ``table_torch.update``; double-buffered async drains with a
    dispatcher attached."""

    # shared with the drain worker; flashlint FL006 holds every access
    # to the state lock (or an audited under-lock/quiescent method). The
    # H_R double-buffer itself lives in the store's SealedFront.
    _fl_guarded = ("state", "_staged_dirty")

    def __init__(self, cfg, state=None, chunk: int = 4096,
                 flush_threshold: Optional[int] = None,
                 query_engine=None, on_flush=None, dispatcher=None,
                 device="cuda"):
        from . import table_torch as tt
        from .store import SealedFront
        self._tt = tt
        self.cfg = cfg
        self.state = tt.init(cfg, device) if state is None else state
        self.chunk = int(chunk)
        self.flush_threshold = int(2 * self.chunk if flush_threshold is None
                                   else flush_threshold)
        self.query_engine = query_engine
        # optional wear listener: called after every device drain with
        # (drained_keys_or_None, Δtile_stores) — ``None`` keys mark the
        # forced merge, whose wear belongs to everything staged since the
        # last merge. Enabling it reads the device stats once per drain.
        self.on_flush = on_flush
        # drain executor (store.FlushDispatcher or None). With one, every
        # drain runs on its worker under its lock; reads take the same
        # lock so (device state, in-flight overlay) is always a
        # consistent snapshot. Without one, drains run inline.
        self.dispatcher = dispatcher
        # the seal/settle/poison double-buffer lifecycle
        self.front = SealedFront(dispatcher=dispatcher)
        # device entries staged since the last merge. An adopted state may
        # arrive with a non-empty change segment, so it counts as dirty:
        # the first merge() must really run.
        self._staged_dirty = state is not None
        self.stats = WriteEngineStats()
        if dispatcher is not None:
            dispatcher.ledger = self.stats

    def _lock(self):
        return (self.dispatcher.lock if self.dispatcher is not None
                else contextlib.nullcontext())

    def _submit(self, fn, label: Optional[str] = None) -> None:
        if self.dispatcher is None:
            fn()
        else:
            self.dispatcher.submit(fn, label=label)

    def _barrier(self) -> None:
        if self.dispatcher is not None:
            self.dispatcher.wait()

    def _settle(self) -> None:
        """Wait out any in-flight work before sealing or taking a no-op
        decision (the double-buffer stall and the poison check live in
        :meth:`SealedFront.settle`)."""
        self.front.settle()

    def _tile_stores(self) -> int:  # flashlint: under-lock
        return int(self.state.stats.tile_stores)

    # -- the buffered write path --------------------------------------------
    def update(self, tokens, deltas=None) -> None:
        """Accumulate a (token, Δ) batch into H_R; auto-flush at the
        threshold. ``EMPTY`` tokens are padding and ignored."""
        self.stats.updates += 1
        uniq, sums, n_valid = dedup_batch(tokens, deltas, self._tt.EMPTY)
        if n_valid == 0:
            return
        self.stats.entries += n_valid
        n_new, cancelled = self.front.fold(uniq, sums)
        self.stats.cancelled += cancelled
        self.stats.buffered += n_new
        self.stats.deduped += n_valid - n_new
        if self.front.active_len() >= self.flush_threshold:
            self.stats.auto_flushes += 1
            self.flush(wait=False)

    # flashlint: quiescent (callers seal post-settle; see the docstring)
    def seal(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Swap H_R: the active buffer becomes the sealed in-flight chunk
        (reads keep overlaying it until its drain lands) and a fresh
        active buffer takes its place. Returns the sealed ``(keys,
        deltas)`` in sorted order, or ``None`` when H_R is empty. Callers
        wait out any previous in-flight drain first (:meth:`flush`)."""
        return self.front.seal()

    # flashlint: under-lock (drain-worker body, submitted via dispatcher)
    def _dispatch(self, keys: np.ndarray, dels: np.ndarray) -> None:
        """Drain one sealed chunk to the device change segment (stage, no
        forced merge) in EMPTY-padded fixed-shape chunks; then clear the
        in-flight overlay and invalidate the paired query engine — all
        atomically with respect to readers (under the dispatcher lock on
        the drain worker, or inline when synchronous)."""
        tt = self._tt
        tt.assert_live(self.state)       # off-thread donation guard
        wear_before = self._tile_stores() if self.on_flush else 0
        dev = self.state.device
        step = self.chunk
        for lo in range(0, keys.size, step):
            pk = keys[lo:lo + step]
            pd = dels[lo:lo + step]
            pad = step - pk.size
            if pad:  # fixed shapes
                pk = np.concatenate([pk, np.full(pad, tt.EMPTY, np.int64)])
                pd = np.concatenate([pd, np.zeros(pad, np.int64)])
            self.state = tt.update(
                self.cfg, self.state,
                torch.as_tensor(pk.astype(np.int32), device=dev),
                torch.as_tensor(pd.astype(np.int32), device=dev))
            self.stats.dispatches += 1
        if self.dispatcher is not None:
            # store contract: a completed drain means the device really
            # holds the entries, not that they sit in the stream's queue.
            # The worker absorbs this wait; the sync baseline pays it
            # inline. Engines without a dispatcher dispatch and go.
            tt.synchronize(self.state)
        self.stats.dispatched_entries += keys.size
        self._staged_dirty = True
        self.front.mark_drained()
        self.stats.flushes += 1
        self._invalidate()
        if self.on_flush:
            self.on_flush(keys, self._tile_stores() - wear_before)

    # flashlint: under-lock (drain-worker body, submitted via dispatcher)
    def _merge_device(self) -> None:
        """Force the device merge of the staged change segment (runs on
        the drain worker under the dispatcher lock, or inline)."""
        tt = self._tt
        tt.assert_live(self.state)
        wear_before = self._tile_stores() if self.on_flush else 0
        self.state = tt.flush(self.cfg, self.state)
        if self.dispatcher is not None:
            tt.synchronize(self.state)     # durable, not queued
        self.stats.merges += 1
        self._staged_dirty = False
        # conservative: the merge moves placement, not counts, but clear
        # the cache anyway — it is one invalidation per rare merge
        self._invalidate()
        if self.on_flush:
            self.on_flush(None, self._tile_stores() - wear_before)

    def flush(self, wait: bool = True):
        """Drain H_R to the device change segment (stage, no forced
        merge). With a dispatcher and ``wait=False`` the sealed buffer
        drains in the background while the caller keeps ingesting;
        ``wait=True`` is the durability barrier for the staged entries."""
        self._settle()
        sealed = self.seal()
        if sealed is not None:
            keys, dels = sealed
            self._submit(lambda: self._dispatch(keys, dels),
                         label=f"hr-drain#{self.front.seals}:{keys.size}e")
        if wait:
            self._barrier()
        # with wait=False a drain may still be rebinding the state: take
        # the lock so callers never observe a half-donated snapshot
        with self._lock():
            return self.state

    def merge(self, wait: bool = True):
        """Flush H_R, then force the device merge of any staged change
        segment (end-of-stream / checkpoint). A complete no-op — nothing
        buffered, nothing in flight, nothing staged since the last merge
        — touches neither the device nor the hot cache."""
        self._settle()
        sealed = self.seal()
        # post-settle probe: no job is in flight here, so the flag and
        # the state are stable until we submit below
        if (sealed is None
                and not self._staged_dirty):  # flashlint: disable=FL006
            if wait:
                self._barrier()
            # no-op path: crucially, no cache invalidation (a flush of
            # an empty engine must not evict every hot key)
            return self.state                 # flashlint: disable=FL006

        def job():
            if sealed is not None:
                self._dispatch(*sealed)
            self._merge_device()

        n = 0 if sealed is None else sealed[0].size
        self._submit(job, label=f"hr-merge#{self.front.seals}:{n}e")
        if wait:
            self._barrier()
        with self._lock():
            return self.state

    # finalize is the adapter-facing spelling of the same operation
    finalize = merge

    def _invalidate(self) -> None:
        if self.query_engine is not None:
            self.query_engine.invalidate()
            self.stats.invalidations += 1

    # -- read-your-writes ---------------------------------------------------
    @property
    def buffered_entries(self) -> int:
        """Unique (token, Δ) entries not yet durable on device: the
        active H_R buffer plus the sealed in-flight chunk (if a drain is
        running). Benign unlocked snapshot (monitoring only, may be
        momentarily stale); never used for control flow."""
        return self.front.entries()

    def pending(self, keys) -> np.ndarray:  # flashlint: under-lock
        """Not-yet-durable Δ per key — the overlay a consolidated read
        must add on top of the device count: the active H_R buffer plus
        the sealed in-flight chunk. Call under the dispatcher lock when
        one is attached (the drain worker clears the in-flight chunk
        under that lock, atomically with the device state rebind)."""
        return self.front.pending(np.asarray(keys).reshape(-1))

    def query_batch(self, keys) -> np.ndarray:
        """Consolidated batched read: device counts through the paired
        query engine, plus the H_R overlay (both buffers). Taken under
        the dispatcher lock, so the device lookup and the overlay always
        describe the same instant — a drain either fully landed (its
        entries are device counts, the in-flight overlay is gone) or not
        at all (they overlay) — never both, never neither."""
        if self.query_engine is None:
            raise ValueError("no paired query engine; construct with "
                             "query_engine=BatchedQueryEngine(cfg)")
        with self._lock():
            base = self.query_engine.query_batch(self.state, keys)
            pend = self.pending(keys)
        return base + pend

    def query(self, key: int) -> int:
        """Single-key convenience wrapper (one-element batch)."""
        return int(self.query_batch(np.asarray([key]))[0])
