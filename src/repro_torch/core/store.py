"""`FlashStore`: the one facade over the flash-hash table backends.

The paper's central claim is that one deferred-update discipline — RAM
buffer H_R in front, semi-random block-local merges behind — serves every
scheme variant (§2, Fig 4). `FlashStore` is the single entry point:

    with FlashStore.open(scheme="MDB-L") as store:   # on the card
        store.update(tokens)            # buffered in H_R
        store.increment(key, -1)        # deletion-by-decrement (§2.6)
        counts = store.query(keys)      # read-your-writes, batched
        store.flush()                   # durability point: drain + merge
        print(store.stats())

Three backends plug in behind the same lifecycle:

* ``device`` — a :class:`~.write_engine.BatchedWriteEngine` paired with a
  :class:`~.query_engine.BatchedQueryEngine` over the device table (the
  card by default, ``device="cpu"`` for the kernels' plain versions); the
  flush → invalidate contract is enforced here, never by callers. Engine
  pairing happens only in this module.
* ``sim`` — the event-level numpy simulator (:mod:`.table_sim`, the
  paper's SSD cost ledger) on the host. It takes no device.
* ``sharded`` — the table split over shards by owner block
  (:mod:`.distributed`): per-shard H_R partitions, shard-local flush
  thresholds, owner-aligned ``all_to_all`` waves and summed lookups; in
  one process over its devices, or one rank of a ``torch.distributed``
  group each.

Flushes are **asynchronous and double-buffered**: ingest fills an active
H_R buffer while one background worker (a :class:`FlushDispatcher` per
store) drains the sealed one. ``flush(wait=True)`` is the durability
barrier; reads overlay both buffers, so read-your-writes holds at every
instant; ``async_flush=False`` drains inline (the ``stall_us`` ledger
then measures what the async path hides).

Durability (DESIGN.md §11): ``wal=`` attaches a chunk-granular
write-ahead log (:mod:`.wal`) — every sealed H_R chunk is appended and
fsync'd before its drain is submitted — and :meth:`FlashStore.snapshot`
/ :meth:`FlashStore.restore` capture the table in the checkpoint layout
and recover it, replaying the log's tail. A device snapshot has the
reference package's layout and array names, so either package restores
the other's.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

EMPTY = -1

_NO_MANAGER = ("snapshot(manager=...) needs the CheckpointManager, which "
               "comes with the training slice of the port (ROADMAP.md, "
               "Queue 1: Training); call snapshot(path) without one")


def _flat_i64(x) -> np.ndarray:
    return np.asarray(x).reshape(-1).astype(np.int64)


class DrainError(RuntimeError):
    """A background drain job died. Raised at the durability barrier
    (``flush(wait=True)`` / ``stats()`` / ``close()``), naming the
    failing job and chunk; the worker's exception rides along as
    ``__cause__``."""


# ---------------------------------------------------------------------------
# the drain dispatcher: one worker thread + state lock per store
# ---------------------------------------------------------------------------
class FlushDispatcher:
    """Background drain executor.

    Owns three things:

    * **the state lock** — every device-state access (drain dispatch,
      forced merge, batched lookup) runs under it, so a reader always
      sees a consistent (device state, in-flight overlay) snapshot;
    * **the one in-flight future** — double buffering means at most one
      sealed buffer is draining; submitting while it drains first waits
      it out;
    * **the overlap/stall ledgers** — written into the attached
      :class:`~.write_engine.WriteEngineStats` (``ledger``): drain time
      on the worker counts as ``overlap_us``, caller time spent waiting
      as ``stall_us``. With ``enabled=False`` drains run inline and their
      full duration is ``stall_us``.

    ``wait()`` is the barrier: it re-raises any drain exception in the
    caller.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.lock = threading.RLock()
        self.ledger = None            # WriteEngineStats sink (set by owner)
        self._pool = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="flashstore-drain")
            if self.enabled else None)
        self._future = None
        self._job_info = None         # (job#, label)
        self._jobs = 0
        self._closed = False

    def _charge(self, field: str, t0: float) -> None:
        if self.ledger is not None:
            us = int((time.perf_counter() - t0) * 1e6)
            setattr(self.ledger, field, getattr(self.ledger, field) + us)

    @property
    def pending(self) -> bool:
        """A submitted job has not been waited out yet."""
        return self._future is not None

    def submit(self, fn, label: Optional[str] = None) -> None:
        """Run one sealed-buffer drain under the state lock: on the
        worker when async, inline when not. Any previous in-flight drain
        is waited out first. ``label`` names the chunk in the
        :class:`DrainError` should the job die."""
        if self._closed:
            raise ValueError("dispatcher is closed")
        self.wait()
        job = self._jobs
        self._jobs += 1
        if not self.enabled:
            t0 = time.perf_counter()
            try:
                with self.lock:
                    fn()
            finally:
                self._charge("stall_us", t0)
            return

        def run():
            t0 = time.perf_counter()
            with self.lock:
                fn()
            self._charge("overlap_us", t0)

        self._job_info = (job, label)
        self._future = self._pool.submit(run)

    def wait(self) -> None:
        """Durability barrier: block until the in-flight drain (if any)
        lands; a worker exception re-raises here as a :class:`DrainError`
        chained to the original."""
        f, self._future = self._future, None
        info, self._job_info = self._job_info, None
        if f is None:
            return
        t0 = time.perf_counter()
        try:
            f.result()
        except Exception as exc:
            job, label = info if info else ("?", None)
            chunk = f" ({label})" if label else ""
            raise DrainError(
                f"background drain job #{job}{chunk} failed: {exc}"
            ) from exc
        finally:
            self._charge("stall_us", t0)

    def close(self) -> None:
        """Join the worker (completing any in-flight drain). Idempotent;
        re-raises a pending drain exception exactly once."""
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# the sealed front: the double-buffered H_R lifecycle
# ---------------------------------------------------------------------------
class SealedFront:
    """The double-buffered H_R lifecycle, written once:

    * **fold** — (token, Δ) pairs accumulate in the *active* buffer of
      their partition (one partition for a single table, one per owner
      shard for the sharded store);
    * **settle** — wait out the in-flight drain; a sealed chunk still
      present *after* the barrier means its drain died, so the front is
      **poisoned**: writes fail loudly rather than silently dropping the
      chunk, and reads keep overlaying it;
    * **seal** — post-settle, the selected partitions' active buffers
      swap for fresh ones and become the read-only *in-flight* overlay;
      the sealed ``(keys, Δs)`` arrays (sorted, deterministic order) go
      to the caller. With a WAL attached, every sealed part is appended
      (one record per part, naming the part) and one fsync lands here —
      **before** the caller submits its drain — so a crash mid-drain
      loses nothing that was sealed;
    * **mark_drained** — worker side, under the dispatcher lock: the
      delivered parts' overlays clear, atomically with the device state
      rebind, and each drained part's commit record is logged.

    ``FlashStore.restore()`` is the way out of the poisoned state
    (:meth:`clear` drops every buffer; the WAL replay re-delivers them).
    """

    # shared with the drain worker; flashlint FL006 holds every access
    # to the state lock (or an audited under-lock/quiescent method)
    _fl_guarded = ("_inflight",)

    def __init__(self, dispatcher: Optional[FlushDispatcher] = None,
                 parts: int = 1, wal=None):
        self.dispatcher = dispatcher
        self.parts = int(parts)
        self.wal = wal
        self._buf: List[Dict[int, int]] = [{} for _ in range(self.parts)]
        # sealed-but-draining chunks: the worker clears a part's slot
        # (under the dispatcher lock) once its entries are on device
        self._inflight: List[Optional[Dict[int, int]]] = [None] * self.parts
        self._wal_seqs: List[Optional[int]] = [None] * self.parts
        self.seals = 0

    def _res(self, part: int) -> str:
        """A part's in-flight overlay by name (the messages name it)."""
        return ("hr:inflight" if self.parts == 1
                else f"hr:inflight[{part}]")

    # -- ingest side ---------------------------------------------------------
    def fold(self, uniq: np.ndarray, sums: np.ndarray,
             owners: Optional[np.ndarray] = None) -> Tuple[int, int]:
        """Fold pre-deduped (token, Δ-sum) pairs into the active buffers
        (partitioned by ``owners`` when given). Returns ``(n_new_slots,
        n_cancelled)`` for the caller's ledger."""
        from .write_engine import fold_entry
        n_new = cancelled = 0
        if owners is None:
            buf = self._buf[0]
            for k, s in zip(uniq.tolist(), sums.tolist()):
                opened = fold_entry(buf, k, s)
                if opened > 0:
                    n_new += 1
                elif opened < 0:
                    cancelled += 1
        else:
            bufs = self._buf
            for k, s, o in zip(uniq.tolist(), sums.tolist(),
                               owners.tolist()):
                opened = fold_entry(bufs[o], k, s)
                if opened > 0:
                    n_new += 1
                elif opened < 0:
                    cancelled += 1
        return n_new, cancelled

    def part_len(self, part: int = 0) -> int:
        """Active-buffer size of one partition (threshold decisions)."""
        return len(self._buf[part])

    def part_lens(self) -> List[int]:
        return [len(b) for b in self._buf]

    # -- lifecycle -----------------------------------------------------------
    def settle(self) -> None:
        """Barrier the in-flight drain, then fail loudly if it died (the
        pre-barrier probe is a benign unlocked read)."""
        d = self.dispatcher
        if (any(b is not None
                for b in self._inflight)      # flashlint: disable=FL006
                or (d is not None and d.pending)):
            if d is not None:
                d.wait()
        dead = [self._res(p) for p, b in enumerate(
            self._inflight) if b is not None]  # flashlint: disable=FL006
        if dead:
            raise RuntimeError(
                f"store is poisoned: a drain failed and its sealed H_R "
                f"chunk ({', '.join(dead)}) was never delivered — reopen "
                f"from the last durable state (FlashStore.restore() clears "
                f"the poison and replays the WAL)")

    # flashlint: quiescent (callers settle first; see the class docstring)
    def seal(self, parts: Optional[List[int]] = None
             ) -> Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]]:
        """Swap the selected partitions' (every partition's by default)
        active buffers into the in-flight overlay; returns ``{part:
        (sorted keys, deltas)}`` or ``None`` when nothing is buffered.
        With a WAL, every sealed part is logged and one fsync lands
        before this returns."""
        sel = [p for p in (range(self.parts) if parts is None else parts)
               if self._buf[p]]
        if not sel:
            return None
        out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for p in sel:
            if self._inflight[p] is not None:
                # never clobber a sealed chunk (a failed drain leaves its
                # entries here — they are still the read overlay)
                raise RuntimeError(
                    f"sealed H_R over an in-flight chunk ({self._res(p)}); "
                    f"wait out the previous drain first")
            b = self._buf[p]
            keys = np.fromiter(b.keys(), np.int64, len(b))
            dels = np.fromiter(b.values(), np.int64, len(b))
            order = np.argsort(keys, kind="stable")  # deterministic
            out[p] = (keys[order], dels[order])
            self._inflight[p] = b
            self._buf[p] = {}
            if self.wal is not None:
                self._wal_seqs[p] = self.wal.append_seal(p, *out[p])
        self.seals += 1
        if self.wal is not None:
            self.wal.sync()           # durable before the drain dispatches
        return out

    def mark_drained(self, parts=None) -> None:  # flashlint: under-lock
        """Worker side, under the dispatcher lock: the sealed chunks of
        ``parts`` (every part by default) are really on device — clear
        their overlays and log their commits."""
        for p in (range(self.parts) if parts is None else parts):
            self._inflight[p] = None
            if self.wal is not None and self._wal_seqs[p] is not None:
                self.wal.append_commit(p, self._wal_seqs[p])
                self._wal_seqs[p] = None

    # -- read-your-writes ----------------------------------------------------
    def pending(self, flat: np.ndarray,
                owners: Optional[np.ndarray] = None) -> np.ndarray:
        # flashlint: under-lock
        """Not-yet-durable Δ per key: active + in-flight buffers of each
        key's partition (``owners``; partition 0 without it). Call under
        the dispatcher lock (the worker clears in-flight slots under
        it)."""
        bufs, inf = self._buf, self._inflight
        if owners is None:
            buf, i0 = bufs[0], inf[0]
            if not buf and not i0:
                return np.zeros(flat.size, np.int64)
            if i0:
                return np.fromiter(
                    (buf.get(int(k), 0) + i0.get(int(k), 0) for k in flat),
                    np.int64, flat.size)
            return np.fromiter((buf.get(int(k), 0) for k in flat),
                               np.int64, flat.size)
        if not any(bufs) and not any(inf):
            return np.zeros(flat.size, np.int64)
        return np.fromiter(
            (bufs[o].get(k, 0) + (inf[o].get(k, 0) if inf[o] else 0)
             for k, o in zip(flat.tolist(), owners.tolist())),
            np.int64, flat.size)

    def buffers(self) -> List[Dict[int, int]]:  # flashlint: under-lock
        """Every partition's active and in-flight buffers that hold
        entries."""
        return [b for b in self._buf + self._inflight if b]

    def entries(self) -> int:
        # benign unlocked snapshot (monitoring only, may be momentarily
        # stale); never used for control flow
        inf = self._inflight                  # flashlint: disable=FL006
        return (sum(len(b) for b in self._buf)
                + sum(len(b) for b in inf if b))

    @property
    def poisoned(self) -> bool:
        """An undelivered sealed chunk survives the barrier (benign
        unlocked probe: only consulted on quiesced paths)."""
        return any(b is not None
                   for b in self._inflight)   # flashlint: disable=FL006

    def clear(self) -> None:  # flashlint: quiescent (restore path, re-armed)
        """Drop every buffer — active and in-flight — clearing any poison.
        Only the restore path calls this, after re-arming the dispatcher:
        the dropped entries are exactly what the WAL replay re-delivers."""
        self._buf = [{} for _ in range(self.parts)]
        self._inflight = [None] * self.parts
        self._wal_seqs = [None] * self.parts


# ---------------------------------------------------------------------------
# sim backend: the event-level SSD simulation
# ---------------------------------------------------------------------------
class SimBackend:
    """`table_sim` behind the store protocol, with the store-level
    double-buffered H_R in front: updates fold into an active host dict;
    sealed chunks replay into the simulator (``update_batch``, the
    engine-chunk-compatible ±Δ twin) on the drain worker, so the async
    lifecycle is the device backend's. The sim's own RAM buffer keeps
    playing the *costed* H_R inside the cost model; ``query_batch``
    already consolidates data/change/overflow + buffer, and the front
    buffers overlay on top. Host only: it takes no device."""

    name = "sim"
    # shared with the drain worker; flashlint FL006 holds every access
    # to the state lock (or an audited under-lock/quiescent method)
    _fl_guarded = ("_dirty",)

    def __init__(self, geom=None, scheme: str = "MDB-L",
                 ram_buffer_pct: float = 5.0,
                 change_segment_pct: float = 12.5,
                 flush_threshold: Optional[int] = None,
                 async_flush: bool = True, wal=None, **table_kw):
        from .flash_model import TableGeometry
        from .table_sim import make_table
        from .write_engine import WriteEngineStats
        self.geom = geom if geom is not None else TableGeometry(
            num_blocks=16, pages_per_block=64, entries_per_page=64)
        self.scheme = scheme
        # ctor args kept for restore-from-scratch (no snapshot on disk)
        self._ram_pct = ram_buffer_pct
        self._cs_pct = change_segment_pct
        self._table_kw = dict(table_kw)
        self.table = make_table(scheme, self.geom, ram_buffer_pct,
                                change_segment_pct, **table_kw)
        # the front H_R seals at the costed RAM buffer's own capacity by
        # default, so threshold behaviour tracks the paper's H_R size
        self.flush_threshold = int(self.table.ram.capacity
                                   if flush_threshold is None
                                   else flush_threshold)
        self._disp = FlushDispatcher(enabled=async_flush)
        self.front = SealedFront(dispatcher=self._disp, wal=wal)
        self._dirty = False          # sim holds undrained/unmerged entries
        self.stats_ledger = WriteEngineStats()
        self._disp.ledger = self.stats_ledger

    # -- the buffered write path -------------------------------------------
    def update(self, tokens, deltas=None) -> None:
        from .write_engine import dedup_batch
        led = self.stats_ledger
        led.updates += 1
        uniq, sums, n_valid = dedup_batch(tokens, deltas, EMPTY)
        if n_valid == 0:
            return
        led.entries += n_valid
        n_new, cancelled = self.front.fold(uniq, sums)
        led.cancelled += cancelled
        led.buffered += n_new
        led.deduped += n_valid - n_new
        if self.front.part_len() >= self.flush_threshold:
            led.auto_flushes += 1
            self.drain(wait=False)

    def _replay(self, keys, dels, merge: bool) -> None:  # flashlint: under-lock
        # worker side, under the dispatcher lock
        led = self.stats_ledger
        if keys is not None:
            self.table.update_batch(keys, dels)
            led.dispatches += 1
            led.dispatched_entries += keys.size
            self._dirty = True
            self.front.mark_drained()
            led.flushes += 1
        if merge:
            self.table.finalize()
            led.merges += 1
            self._dirty = False
        elif keys is not None:
            self.table.flush()       # stage, no forced merge

    def _seal(self) -> Optional[tuple]:  # flashlint: quiescent (post-settle)
        out = self.front.seal()
        return None if out is None else out[0]

    def drain(self, wait: bool = True) -> None:
        self.front.settle()
        sealed = self._seal()
        if sealed is not None:
            k, d = sealed
            self._disp.submit(lambda: self._replay(k, d, merge=False),
                              label=f"sim-drain#{self.front.seals}:"
                                    f"{k.size}e")
        if wait:
            self._disp.wait()

    def flush(self, wait: bool = True) -> None:  # durability point
        self.front.settle()
        sealed = self._seal()
        # post-settle probe: no job in flight, the flag is stable
        if sealed is None and not self._dirty:  # flashlint: disable=FL006
            if wait:
                self._disp.wait()
            return                    # complete no-op
        k, d = sealed if sealed is not None else (None, None)
        n = 0 if k is None else k.size
        self._disp.submit(lambda: self._replay(k, d, merge=True),
                          label=f"sim-flush#{self.front.seals}:{n}e")
        if wait:
            self._disp.wait()

    # -- read-your-writes ---------------------------------------------------
    def query_batch(self, keys) -> np.ndarray:
        with self._disp.lock:
            base = np.asarray(self.table.query_batch(keys), np.int64)
            pend = self.front.pending(_flat_i64(keys))
        return base + pend

    def pending_entries(self) -> int:
        return self.front.entries() + len(self.table.ram.items)

    # -- durability ----------------------------------------------------------
    # flashlint: quiescent (facade snapshots post-flush; nothing in flight)
    def snapshot_state(self, path, step: int, meta: Dict) -> Path:
        """Capture the whole costed simulator (table + its own RAM buffer
        + ledgers) in the checkpoint layout, as one pickle carried as a
        byte array: the sim is a plain numpy/host object graph, so
        pickling round-trips it exactly."""
        import pickle
        from ..checkpoint.checkpoint import save_checkpoint
        with self._disp.lock:
            blob = pickle.dumps(self.table)
        return save_checkpoint(path, step,
                               {"sim_table": np.frombuffer(blob, np.uint8)},
                               extra_meta=meta)

    # flashlint: quiescent (restore path: dispatcher re-armed, no worker)
    def restore_state(self, path, step: Optional[int] = None):
        """Load the pickled simulator from ``path`` (latest ``step_*`` or
        an explicit ``step``); with no snapshot on disk, rebuild a fresh
        table so the WAL replay starts from zero. Returns
        ``(step | None, meta)``. The pickle is one this backend wrote."""
        import pickle
        from ..checkpoint.checkpoint import latest_step, restore_checkpoint
        from .table_sim import make_table
        if path is not None and step is None:
            step = latest_step(path)
        if path is None or step is None:
            self.table = make_table(self.scheme, self.geom, self._ram_pct,
                                    self._cs_pct, **self._table_kw)
            self._dirty = False
            return None, {}
        arrays, meta = restore_checkpoint(path, step=step)
        self.table = pickle.loads(arrays["sim_table"].tobytes())
        self._dirty = False
        return step, meta

    def rearm(self) -> None:
        """Replace a (possibly wedged/poisoned) dispatcher with a fresh
        worker of the same sync/async flavour; the restore path calls
        this before clearing the front."""
        old = self._disp
        self._disp = FlushDispatcher(enabled=old.enabled)
        self._disp.ledger = self.stats_ledger
        self.front.dispatcher = self._disp
        try:
            old.close()
        except DrainError:
            pass                      # the poison already surfaced once

    def partition_heat(self, keys) -> np.ndarray:
        return np.zeros(_flat_i64(keys).size)     # no device wear feed

    def wear(self) -> Dict[str, int]:
        """The sim's wear counters: ``cleans`` *is* the paper's erase
        count (the device backend's ``tile_stores`` analogue)."""
        self._disp.wait()
        led = self.table.ledger
        return {"cleans": led.cleans, "block_ops": led.block_ops,
                "page_ops": led.page_ops, "merges": led.merges,
                "stages": led.stages}

    def stats(self) -> Dict[str, int]:
        self._disp.wait()             # quiesce: one consistent ledger
        led = self.table.ledger
        q = self.table.qstats
        out = {"backend": self.name, "scheme": self.scheme,
               "cleans": led.cleans, "block_ops": led.block_ops,
               "page_ops": led.page_ops, "merges": led.merges,
               "stages": led.stages, "queries": q.queries,
               "found": q.found,
               "buffered_entries": self.pending_entries()}
        out.update({f"write_{k}": v
                    for k, v in self.stats_ledger.as_dict().items()})
        return out

    def close(self) -> None:
        self._disp.close()


# ---------------------------------------------------------------------------
# device backend: single-table engine pair
# ---------------------------------------------------------------------------
class DeviceBackend:
    """The engine pair, auto-wired: one
    :class:`~.write_engine.BatchedWriteEngine` owning the table state,
    one paired :class:`~.query_engine.BatchedQueryEngine`, flush →
    invalidate enforced by construction. With ``track_wear=True`` the
    backend attributes per-drain ``TableStats`` wear deltas
    (Δ``tile_stores``) to change-segment partitions.

    The backend remembers the device its table lives on (``device``, or
    the device of a passed-in ``state``): :meth:`restore_state` puts a
    restored table back there. Nothing the engines hold refers back to
    the backend (the Bloom pre-filter binds the config, the wear listener
    a weak reference), so a closed and dropped backend frees its device
    table without waiting for the cycle collector."""

    name = "device"
    # the wear ledger is mutated by _on_drain on the drain worker; FL006
    # holds every access to the state lock or an audited method
    _fl_guarded = ("_wear",)

    def __init__(self, cfg=None, state=None, chunk: int = 4096,
                 query_chunk: int = 1024,
                 flush_threshold: Optional[int] = None,
                 hot_capacity: int = 4096, track_wear: bool = False,
                 async_flush: bool = True, device="cuda", wal=None,
                 **table_kw):
        from . import table_torch as tt
        from .query_engine import BatchedQueryEngine
        from .write_engine import BatchedWriteEngine, PartitionHeatLedger
        self.cfg = cfg = (cfg if cfg is not None
                          else tt.FlashTableConfig(**table_kw))
        self.scheme = cfg.scheme
        self.device = (tt.resolve_device(device) if state is None
                       else state.device)
        self.query_engine = BatchedQueryEngine(
            cfg, chunk=query_chunk, hot_capacity=hot_capacity,
            filter_fn=((lambda state, q: tt.filter_probe(cfg, state, q))
                       if cfg.filters else None))
        self._track_wear = bool(track_wear)
        self._disp = FlushDispatcher(enabled=async_flush)
        on_drain = None
        if track_wear:
            listener = weakref.WeakMethod(self._on_drain)

            def on_drain(keys, wear_delta):
                fn = listener()
                if fn is not None:
                    fn(keys, wear_delta)
        self.writer = BatchedWriteEngine(
            cfg, state=state, chunk=chunk,
            flush_threshold=flush_threshold, query_engine=self.query_engine,
            on_flush=on_drain, dispatcher=self._disp, device=self.device,
            wal=wal)
        # wear attribution: partition -> accumulated Δtile_stores share,
        # plus the staged-since-last-merge histogram merges are charged to
        self._wear = PartitionHeatLedger()

    # -- wear attribution ---------------------------------------------------
    def _partition_of(self, keys: np.ndarray) -> np.ndarray:
        """Host-side partition id: MDB's change-segment partition when the
        scheme has one, else the data block itself."""
        s = self.cfg.pair.s(torch.as_tensor(np.asarray(keys, np.int64))
                            ).numpy().astype(np.int64)
        if self.scheme == "MDB":
            return s // self.cfg.blocks_per_partition
        return s

    def _on_drain(self, keys, wear_delta: int) -> None:  # flashlint: under-lock
        # charge the measured Δtile_stores to the partitions staged since
        # the last forced merge, proportional to staged volume;
        # keys=None marks the forced merge that drains the histogram
        parts_counts = None
        if keys is not None:                 # H_R drain: staged entries
            parts, counts = np.unique(self._partition_of(keys),
                                      return_counts=True)
            parts_counts = list(zip(parts.tolist(), counts.tolist()))
        self._wear.note(parts_counts, wear_delta)

    def partition_heat(self, keys) -> np.ndarray:
        """Write pressure of each key's partition: entries pending for it
        (both H_R buffers + staged-unmerged) plus the decayed per-merge
        ``TableStats`` wear history. Takes the dispatcher lock:
        ``_on_drain`` mutates the ledgers on the drain worker."""
        flat = _flat_i64(keys)
        if flat.size == 0:
            return np.zeros(0)
        with self._disp.lock:
            pending, heat = self._wear.snapshot()
            for b in self.writer.front.buffers():
                bk = np.fromiter(b.keys(), np.int64, len(b))
                parts, counts = np.unique(self._partition_of(bk),
                                          return_counts=True)
                for p, c in zip(parts.tolist(), counts.tolist()):
                    pending[p] = pending.get(p, 0) + c
        if not pending and not heat:
            return np.zeros(flat.size)
        parts = self._partition_of(flat)
        return np.asarray([pending.get(int(p), 0)
                           + heat.get(int(p), 0.0) for p in parts])

    # -- protocol -----------------------------------------------------------
    @property
    def state(self):
        return self.writer.state

    @property
    def front(self) -> SealedFront:
        return self.writer.front

    def update(self, tokens, deltas=None) -> None:
        self.writer.update(tokens, deltas)

    def query_batch(self, keys) -> np.ndarray:
        return self.writer.query_batch(keys)

    def drain(self, wait: bool = True) -> None:
        self.writer.flush(wait=wait)

    def flush(self, wait: bool = True) -> None:
        self.writer.merge(wait=wait)

    def pending_entries(self) -> int:
        return self.writer.buffered_entries

    def wear(self) -> Dict[str, int]:
        self._disp.wait()             # quiesce: device counters settled
        s = self.state.stats
        return {f: int(getattr(s, f)) for f in s._fields}

    def stats(self) -> Dict[str, int]:
        out = {"backend": self.name, "scheme": self.scheme}
        out.update(self.wear())       # barriers the in-flight drain
        out.update({f"write_{k}": v
                    for k, v in self.writer.stats.as_dict().items()})
        out.update({f"query_{k}": v
                    for k, v in self.query_engine.stats.as_dict().items()})
        out["buffered_entries"] = self.pending_entries()
        return out

    # -- durability ----------------------------------------------------------
    # flashlint: quiescent (facade snapshots post-flush; nothing in flight)
    def snapshot_state(self, path, step: int, meta: Dict) -> Path:
        """Write the device table state through the checkpoint layout
        (atomic tmp + rename ``step_<N>/{meta.json, arrays.npz}``), with
        the reference package's array names."""
        from .. import convert
        from ..checkpoint.checkpoint import flatten, save_checkpoint
        return save_checkpoint(path, step,
                               flatten(convert.state_to_numpy(self.state)),
                               extra_meta=meta)

    # flashlint: quiescent (restore path: dispatcher re-armed, no worker)
    def restore_state(self, path, step: Optional[int] = None):
        """Load the table state from the latest (or given) snapshot under
        ``path`` onto this backend's device; with no snapshot, re-init a
        fresh table so the WAL replay starts from zero. Returns
        ``(step | None, meta)``."""
        from .. import convert
        from ..checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                             unflatten)
        from . import table_torch as tt
        if path is not None and step is None:
            step = latest_step(path)
        if path is None or step is None:
            self.writer.state = tt.init(self.cfg, self.device)
            meta, step = {}, None
        else:
            arrays, meta = restore_checkpoint(path, step=step)
            self._check_shapes(arrays)
            self.writer.state = convert.state_from_numpy(
                unflatten(arrays), device=self.device)
        self.writer._staged_dirty = True  # snapshot may hold staged segments
        self._wear.clear()
        self.query_engine.invalidate()    # a cached count is pre-crash
        return step, meta

    def _check_shapes(self, arrays: Dict[str, np.ndarray]) -> None:
        """Refuse a snapshot of another geometry: every array of this
        config's state must be present with its shape."""
        from . import table_torch as tt
        st = tt.init(self.cfg, "meta")       # shapes only, no storage
        want = {f: tuple(getattr(st, f).shape) for f in st._fields
                if f != "stats"}
        want.update({f"stats/{f}": tuple(getattr(st.stats, f).shape)
                     for f in st.stats._fields})
        missing = sorted(set(want) - set(arrays))
        if missing:
            raise KeyError(f"snapshot missing arrays: {missing[:5]}")
        for k, shape in want.items():
            if tuple(arrays[k].shape) != shape:
                raise ValueError(f"{k}: shape {arrays[k].shape} != {shape}")

    def rearm(self) -> None:
        """Replace a (possibly wedged/poisoned) dispatcher with a fresh
        worker; restore calls this before clearing the front."""
        old = self._disp
        self._disp = FlushDispatcher(enabled=old.enabled)
        self._disp.ledger = self.writer.stats
        self.writer.dispatcher = self._disp
        self.writer.front.dispatcher = self._disp
        try:
            old.close()
        except DrainError:
            pass                      # the poison already surfaced once

    def close(self) -> None:
        self._disp.close()


# ---------------------------------------------------------------------------
# sharded backend: per-shard H_R partitions over the sharded table
# ---------------------------------------------------------------------------
class ShardedBackend:
    """The sharded table (:mod:`.distributed`) behind the store protocol.

    * **per-shard H_R partitions** — the host buffer is split by
      ``owner(x)`` (the two-level hash that shards the data segment), so
      dedup / cancellation state is per shard and a drain can target one
      shard's traffic;
    * **shard-local flush thresholds** — a partition drains when *it*
      fills; the other shards' buffers stay warm instead of being forced
      out by a global count. The collective has a fixed shape anyway, so
      partitions at least ``piggyback_frac`` full ride along;
    * **owner-aligned dispatch** — drained entries are placed in their
      owner shard's slice of the wave, so the ``all_to_all`` routes every
      entry from a shard to itself and no (src, dst) bucket can overflow
      (``shard_chunk <= bucket_cap`` entries, all self-owned);
    * **consolidated lookups** — one sharded lookup per EMPTY-padded query
      chunk (every shard probes its blocks, one sum combines), fronted by
      the :class:`~.query_engine.BatchedQueryEngine` hot cache and the H_R
      overlay.

    The shards live on ``device``: every visible card by default, shard
    ``i`` on card ``i % count``; one named device (``"cuda:0"``,
    ``"cpu"``) holds them all; ``stats()`` names the placement.

    **Several processes.** When ``torch.distributed`` is initialised with
    more than one process at construction, the same backend runs as one
    rank of a group: the shards split evenly over the ranks, each rank
    folds its own ingest into its local H_R partitions, and the
    ``all_to_all`` routes drained entries to their owners across ranks
    over the caller's process group (its backend is the caller's choice:
    gloo, NCCL). Then:

    * drains, flushes and queries are **collective** — every rank calls
      them at the same point (no threshold auto-flush; the caller drives
      the drain cadence), and ``query_batch`` takes identical keys on
      every rank;
    * ranks first **agree on the number of drain waves** (and whether a
      device merge is pending anywhere) through a max on the caller
      thread after settle, so the worker's collectives keep one global
      order (``agree_k < waves_k < agree_{k+1}``) while still overlapping
      each rank's ingest;
    * each rank packs its sealed entries into its **local shards' slices**
      only (at most ``shard_chunk`` a slice), so ``write_carried == 0``
      holds while the ``all_to_all`` routes across ranks; a rank with
      nothing sealed still runs its share of the waves with EMPTY slices.
    """

    name = "sharded"
    # shared with the drain worker; flashlint FL006 holds every access
    # to the state lock (or an audited under-lock/quiescent method)
    _fl_guarded = ("state", "_staged_dirty", "_wear")

    def __init__(self, cfg=None, num_shards: Optional[int] = None,
                 shard_chunk: Optional[int] = None,
                 flush_threshold: Optional[int] = None,
                 query_chunk: int = 1024, hot_capacity: int = 4096,
                 piggyback_frac: float = 0.5, async_flush: bool = True,
                 track_wear: bool = True, device="cuda", wal=None,
                 **table_kw):
        import torch.distributed as dist

        from . import distributed as D
        from . import table_torch as tt
        from .query_engine import BatchedQueryEngine
        from .write_engine import PartitionHeatLedger, WriteEngineStats
        multi = dist.is_initialized() and dist.get_world_size() > 1
        devices = D.resolve_devices(device, distributed=multi)
        if cfg is None or isinstance(cfg, tt.FlashTableConfig):
            n = int(num_shards if num_shards is not None
                    else len(devices) * (dist.get_world_size() if multi
                                         else 1))
            local = cfg if cfg is not None else tt.FlashTableConfig(
                **table_kw)
            cfg = D.ShardedTableConfig(local=local, num_shards=n)
        self.cfg = cfg
        n = cfg.num_shards
        if n & (n - 1):
            raise ValueError(f"num_shards={n} must be a power of two")
        self.scheme = cfg.local.scheme
        self.group = D.ShardGroup(n, devices,
                                  dist.group.WORLD if multi else None)
        self.multihost = multi
        self.num_processes = self.group.world_size
        self.process_index = self.group.rank
        self.shard_chunk = int(min(cfg.bucket_cap, shard_chunk or 1024))
        self.flush_threshold = int(2 * self.shard_chunk
                                   if flush_threshold is None
                                   else flush_threshold)
        self.piggyback_frac = float(piggyback_frac)
        group = self.group
        self.query_engine = BatchedQueryEngine(
            cfg.local, chunk=query_chunk, hot_capacity=hot_capacity,
            lookup_fn=lambda states, q: D.lookup_ex(cfg, group, states, q),
            filter_fn=((lambda states, q: D.filter_probe(cfg, group,
                                                         states, q))
                       if cfg.local.filters else None))
        self.state = D.init_states(cfg, group)
        self._staged_dirty = False    # staged entries since last merge
        self._disp = FlushDispatcher(enabled=async_flush)
        # per-shard H_R partitions behind the one sealed-front lifecycle
        self.front = SealedFront(dispatcher=self._disp, parts=n, wal=wal)
        self.stats_ledger = WriteEngineStats()
        self._disp.ledger = self.stats_ledger
        self.piggybacked = 0
        self.carried = 0
        # per-block heat keyed by *global* block id, so heat depends on
        # the trace and not on how the shards split over processes; a
        # merge is charged the staged volume since the last one (the
        # trace-derived twin of DeviceBackend's Δtile_stores feed)
        self._track_wear = bool(track_wear)
        self._wear = PartitionHeatLedger()

    # -- owner routing ------------------------------------------------------
    def owner_of(self, keys) -> np.ndarray:
        """Owner shard per key: the global block id's top (shard) bits."""
        from . import distributed as D
        return D.owner_of(self.cfg, torch.as_tensor(_flat_i64(keys))
                          ).numpy().astype(np.int64)

    def _global_blocks(self, keys: np.ndarray) -> np.ndarray:
        return self.cfg.global_pair.s(torch.as_tensor(keys)).numpy()

    # -- the buffered write path -------------------------------------------
    def update(self, tokens, deltas=None) -> None:
        from .write_engine import dedup_batch
        led = self.stats_ledger
        led.updates += 1
        uniq, sums, n_valid = dedup_batch(tokens, deltas, EMPTY)
        if n_valid == 0:
            return
        led.entries += n_valid
        n_new, cancelled = self.front.fold(uniq, sums, self.owner_of(uniq))
        led.cancelled += cancelled
        led.buffered += n_new
        led.deduped += n_valid - n_new
        if self.multihost:
            # drains are collective: a rank-local threshold must not start
            # a collective the other ranks do not know about; the caller
            # drives the drain cadence
            return
        lens = self.front.part_lens()
        hot = [i for i, ln in enumerate(lens) if ln >= self.flush_threshold]
        if hot:
            led.auto_flushes += 1
            ride = [i for i, ln in enumerate(lens)
                    if i not in hot
                    and ln >= self.piggyback_frac * self.flush_threshold]
            self.piggybacked += len(ride)
            self.drain(shards=hot + ride, wait=False)

    def _wave(self, slices: List[Tuple[np.ndarray, np.ndarray]]):
        # flashlint: under-lock (drain-worker body)
        """One collective update wave: local shard ``i`` contributes the
        ``slices[i]`` (keys, deltas), EMPTY-padded to ``shard_chunk``.
        Consumes the shards' states and returns their successors; the
        caller rebinds them."""
        from . import distributed as D
        step = self.shard_chunk
        toks, dels = [], []
        for dev, (ks, vs) in zip(self.group.devices, slices):
            t = np.full(step, EMPTY, np.int32)
            d = np.zeros(step, np.int32)
            t[:ks.size] = ks
            d[:vs.size] = vs
            toks.append(torch.as_tensor(t, device=dev))
            dels.append(torch.as_tensor(d, device=dev))
        states, n_carry = D.update(self.cfg, self.group, self.state, toks,
                                   dels)
        self.stats_ledger.dispatches += 1
        self.carried += n_carry
        return states

    # flashlint: under-lock (drain-worker body, submitted via dispatcher)
    def _drain_sealed(self, per_shard: Dict) -> None:
        """Dispatch sealed shard partitions to their owners' change
        segments (no forced merge) — worker side, under the dispatcher
        lock. One fixed-shape collective per ``shard_chunk``-entry wave;
        every drained entry rides in its owner's slice, so the
        ``all_to_all`` moves every entry from its shard to itself."""
        from . import distributed as D
        step = self.shard_chunk
        led = self.stats_ledger
        for s in self.state:
            D.assert_live(s)          # off-thread donation guard
        none = (np.zeros(0, np.int64),) * 2
        waves = max(-(-ks.size // step) for ks, _ in per_shard.values())
        for w in range(waves):
            cut = slice(w * step, (w + 1) * step)
            self.state = self._wave(
                [tuple(a[cut] for a in per_shard.get(s, none))
                 for s in self.group.local_shards])
        D.synchronize(self.state)     # durable, not merely queued
        self._staged_dirty = True
        for ks, _vs in per_shard.values():
            led.dispatched_entries += ks.size
        self._note_staged(per_shard)
        self.front.mark_drained(sorted(per_shard))
        led.flushes += 1
        self.query_engine.invalidate()
        led.invalidations += 1

    def _note_staged(self, per_shard: Dict) -> None:  # flashlint: under-lock
        """Feed the wear ledger with the drained entries, keyed by global
        block id (the same whatever the split over processes). Worker
        side, under the dispatcher lock."""
        if not self._track_wear or not per_shard:
            return
        blocks = np.concatenate([self._global_blocks(ks)
                                 for ks, _vs in per_shard.values()])
        parts, counts = np.unique(blocks, return_counts=True)
        self._wear.note(list(zip(parts.tolist(), counts.tolist())), 0)

    # flashlint: under-lock (drain-worker body, submitted via dispatcher)
    def _merge_device(self) -> None:
        """Force the device merge of every shard's staged change segment
        — worker side, under the dispatcher lock."""
        from . import distributed as D
        for s in self.state:
            D.assert_live(s)
        self.state = D.flush(self.cfg, self.state)
        D.synchronize(self.state)
        self.stats_ledger.merges += 1
        self._staged_dirty = False
        if self._track_wear:
            self._wear.note(None, float(sum(self._wear.staged.values())))
        self.query_engine.invalidate()
        self.stats_ledger.invalidations += 1

    # -- several processes --------------------------------------------------
    def _agree(self, waves: int, dirty: int) -> Tuple[int, int]:
        """Caller-thread agreement: the maximum over the ranks of
        ``(waves, dirty)``. Runs post-settle, so no worker collective is
        in flight and the global order ``agree_k < waves_k <
        agree_{k+1}`` holds on every rank."""
        got = self.group.pmax(torch.tensor([waves, dirty], dtype=torch.int32,
                                           device=self.group.home))
        return int(got[0]), int(got[1])

    def _drain_collective(self, merge: bool, wait: bool) -> None:
        """Drain / flush on several processes: seal every local
        partition, agree on the number of waves (and, for a flush, on
        whether any rank holds staged segments), then submit one worker
        job that runs exactly the agreed collectives — the same on every
        rank."""
        per_shard = self.front.seal()
        total = (sum(ks.size for ks, _vs in per_shard.values())
                 if per_shard else 0)
        budget = len(self.group.local_shards) * self.shard_chunk
        waves = -(-total // budget) if total else 0
        # post-settle probe: no job in flight, the flag is stable
        dirty = 1 if (merge and
                      self._staged_dirty) else 0  # flashlint: disable=FL006
        g_waves, g_dirty = self._agree(waves, dirty)
        if g_waves == 0 and not (merge and g_dirty):
            if wait:
                self._disp.wait()
            return

        def job():
            self._drain_sealed_multihost(per_shard, g_waves)
            if merge and g_dirty:
                self._merge_device()

        kind = "flush" if merge else "drain"
        mine = sorted(per_shard) if per_shard else []
        self._disp.submit(job, label=f"mh-{kind}#{self.front.seals}:"
                                     f"waves{g_waves}:shards{mine}")
        if wait:
            self._disp.wait()

    # flashlint: under-lock (drain-worker body, submitted via dispatcher)
    def _drain_sealed_multihost(self, per_shard: Optional[Dict],
                                waves: int) -> None:
        """Run the agreed number of waves, packing this rank's sealed
        entries into its local shards' slices (the ``all_to_all`` routes
        them to their owners). A slice holds at most ``shard_chunk <=
        bucket_cap`` entries, so no (src, dst) bucket can overflow."""
        from . import distributed as D
        step = self.shard_chunk
        per = len(self.group.local_shards)
        led = self.stats_ledger
        for s in self.state:
            D.assert_live(s)
        if per_shard:
            order = sorted(per_shard)
            ks = np.concatenate([per_shard[s][0] for s in order])
            vs = np.concatenate([per_shard[s][1] for s in order])
        else:
            ks = vs = np.zeros(0, np.int64)
        for w in range(waves):
            lo = w * per * step
            self.state = self._wave(
                [(ks[lo + j * step:lo + (j + 1) * step],
                  vs[lo + j * step:lo + (j + 1) * step])
                 for j in range(per)])
        D.synchronize(self.state)
        if waves:
            # other ranks' entries may have landed in our shards' change
            # segments even when we sealed nothing
            self._staged_dirty = True
        if per_shard:
            for pks, _pvs in per_shard.values():
                led.dispatched_entries += pks.size
            self._note_staged(per_shard)
            self.front.mark_drained(sorted(per_shard))
            led.flushes += 1
        self.query_engine.invalidate()
        led.invalidations += 1

    def drain(self, shards: Optional[List[int]] = None,
              wait: bool = True) -> None:
        """Seal the selected shards' H_R partitions (every shard's by
        default) and drain them on the worker (no forced merge). With
        several processes this is collective: every rank seals *all* its
        partitions (``shards`` is ignored) and the ranks agree on the
        wave count first."""
        self.front.settle()
        if self.multihost:
            self._drain_collective(merge=False, wait=wait)
            return
        per_shard = self.front.seal(shards)
        if per_shard is not None:
            self._disp.submit(lambda: self._drain_sealed(per_shard),
                              label=f"shard-drain#{self.front.seals}:"
                                    f"shards{sorted(per_shard)}")
        if wait:
            self._disp.wait()

    def flush(self, wait: bool = True) -> None:
        """Durability point: drain every H_R partition, then force the
        device merge of every shard's staged change segment. A complete
        no-op — nothing buffered, in flight or staged — touches neither
        the device nor the hot cache. Collective with several processes
        (the merge runs everywhere when *any* rank has staged
        segments)."""
        self.front.settle()
        if self.multihost:
            self._drain_collective(merge=True, wait=wait)
            return
        per_shard = self.front.seal()
        # post-settle probe: no job is in flight here, so the flag is
        # stable until we submit below
        if (per_shard is None
                and not self._staged_dirty):  # flashlint: disable=FL006
            if wait:
                self._disp.wait()
            return

        def job():
            if per_shard is not None:
                self._drain_sealed(per_shard)
            self._merge_device()

        shards = sorted(per_shard) if per_shard else []
        self._disp.submit(job, label=f"shard-flush#{self.front.seals}:"
                                     f"shards{shards}")
        if wait:
            self._disp.wait()

    # -- read-your-writes ---------------------------------------------------
    def pending_entries(self) -> int:
        return self.front.entries()

    def pending(self, keys) -> np.ndarray:  # flashlint: under-lock
        """Not-yet-durable Δ per key: active + in-flight partition of the
        key's owner shard. Call under the dispatcher lock."""
        flat = _flat_i64(keys)
        return self.front.pending(flat, self.owner_of(flat))

    def query_batch(self, keys) -> np.ndarray:
        if self.multihost:
            # lookups are collective: barrier the in-flight drain first so
            # every rank issues them at the same point of the global order
            self._disp.wait()
        with self._disp.lock:
            base = self.query_engine.query_batch(self.state, keys)
            pend = self.pending(keys)
        return base + pend

    def partition_heat(self, keys) -> np.ndarray:
        """Write pressure of each key's *global* block: this rank's H_R
        entries pending for it (active + in-flight) plus the decayed
        per-merge heat of the trace-derived wear ledger. The same trace
        gives the same heat on one process with 8 shards and on two with
        4 each."""
        flat = _flat_i64(keys)
        if flat.size == 0:
            return np.zeros(0)
        with self._disp.lock:
            pending, heat = self._wear.snapshot()
            for b in self.front.buffers():
                bk = np.fromiter(b.keys(), np.int64, len(b))
                parts, counts = np.unique(self._global_blocks(bk),
                                          return_counts=True)
                for p, c in zip(parts.tolist(), counts.tolist()):
                    pending[p] = pending.get(p, 0) + c
        if not pending and not heat:
            return np.zeros(flat.size)
        parts = self._global_blocks(flat)
        return np.asarray([pending.get(int(p), 0)
                           + heat.get(int(p), 0.0) for p in parts])

    def wear(self) -> Dict[str, int]:  # flashlint: quiescent
        """Device wear counters summed over the local shards: every shard
        in one process, this rank's with several (the drains route every
        entry to its owner, so the ranks' reports sum to the whole)."""
        self._disp.wait()             # quiesce: device counters settled
        fields = self.state[0].stats._fields
        return {f: sum(int(getattr(s.stats, f)) for s in self.state)
                for f in fields}

    def stats(self) -> Dict[str, int]:
        out = {"backend": self.name, "scheme": self.scheme,
               "shards": self.cfg.num_shards}
        out.update(self.wear())       # barriers the in-flight drain
        out.update({f"write_{k}": v
                    for k, v in self.stats_ledger.as_dict().items()})
        out.update({f"query_{k}": v
                    for k, v in self.query_engine.stats.as_dict().items()})
        out["buffered_entries"] = self.pending_entries()
        out["write_piggybacked"] = self.piggybacked
        out["write_carried"] = self.carried
        out["buffered_per_shard_max"] = max(self.front.part_lens(),
                                            default=0)
        out["collectives"] = self.group.backend
        out["placement"] = self.group.placement()
        return out

    # -- durability ----------------------------------------------------------
    # flashlint: quiescent (facade snapshots post-flush; nothing in flight)
    def snapshot_state(self, path, step: int, meta: Dict) -> Path:
        """Write the shards' states in the reference's stacked global
        layout through the checkpoint layout, with its array names, so
        either package restores the other's. Several processes recover
        through their per-host WALs instead: a global snapshot would need
        a gather the checkpoint layer does not have."""
        if self.multihost:
            raise NotImplementedError(
                "a sharded store over several processes snapshots through "
                "its per-host WALs (FlashStore.restore replays them); a "
                "global snapshot needs a gather the checkpoint layer lacks")
        from . import distributed as D
        from ..checkpoint.checkpoint import flatten, save_checkpoint
        return save_checkpoint(path, step,
                               flatten(D.global_arrays(self.state)),
                               extra_meta=meta)

    # flashlint: quiescent (restore path: dispatcher re-armed, no worker)
    def restore_state(self, path, step: Optional[int] = None):
        """Load the shards from the latest (or given) snapshot under
        ``path`` onto their devices; with no snapshot, re-init fresh so
        the WAL replay starts from zero. Returns ``(step | None,
        meta)``."""
        from . import distributed as D
        from ..checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                             unflatten)
        if path is not None and step is None:
            step = latest_step(path)
        if path is None or step is None:
            self.state = D.init_states(self.cfg, self.group)
            meta, step = {}, None
        else:
            if self.multihost:
                raise NotImplementedError(
                    "a sharded store over several processes restores from "
                    "its per-host WALs over a fresh init (path=None)")
            arrays, meta = restore_checkpoint(path, step=step)
            self.state = D.from_global_arrays(self.cfg, unflatten(arrays),
                                              self.group)
        self._staged_dirty = True     # snapshot may hold staged segments
        self._wear.clear()
        self.query_engine.invalidate()
        return step, meta

    def rearm(self) -> None:
        """Replace a (possibly wedged/poisoned) dispatcher with a fresh
        worker; restore calls this before clearing the front."""
        old = self._disp
        self._disp = FlushDispatcher(enabled=old.enabled)
        self._disp.ledger = self.stats_ledger
        self.front.dispatcher = self._disp
        try:
            old.close()
        except DrainError:
            pass                      # the poison already surfaced once

    def close(self) -> None:
        self._disp.close()


_BACKENDS = {"sim": SimBackend, "device": DeviceBackend,
             "sharded": ShardedBackend}


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RestoreReport:
    """What :meth:`FlashStore.restore` did: the recovery audit trail."""

    snapshot_step: Optional[int]  # step restored from (None: fresh init)
    base_seq: int                 # WAL seqs <= this were pre-rotation
    records_replayed: int         # sealed WAL chunks re-applied
    entries_replayed: int         # (token, Δ) pairs re-applied
    tail_discarded_bytes: int     # torn WAL tail dropped (warned loudly)
    poison_cleared: bool          # the store was poisoned going in
    meta: Dict                    # snapshot meta.json (includes extras)


class FlashStore:
    """Counting hash table with the paper's deferred-update discipline
    built in. Construct with :meth:`open`; use as a context manager for
    automatic flush-on-exit."""

    def __init__(self, backend_impl):
        self._b = backend_impl
        self._closed = False

    @classmethod
    def open(cls, config=None, backend: str = "device", device=None,
             **kw) -> "FlashStore":
        """One constructor for every backend.

        ``config`` is backend-shaped — a ``TableGeometry`` for ``sim``, a
        ``FlashTableConfig`` for ``device``, a ``ShardedTableConfig`` (or
        the local ``FlashTableConfig``) for ``sharded`` — or ``None`` to
        build one from ``**kw`` (``scheme=``, ``q_log2=``, ...). Engine
        knobs (``chunk``, ``flush_threshold``, ``query_chunk``,
        ``hot_capacity``, ``async_flush``; for ``sharded``
        ``num_shards``, ``shard_chunk``, ``piggyback_frac``) pass through
        as keywords. The device table lives on ``device``: the card by
        default (raising when there is none; every visible card for
        ``sharded``), ``"cpu"`` for the plain versions of the kernels.
        The sim runs on the host and takes no ``device``. ``sharded``
        runs as one rank of a group when ``torch.distributed`` is
        initialised with more than one process.

        ``wal=`` (a path, or a :class:`~.wal.WriteAheadLog`) attaches a
        chunk-granular write-ahead log: every sealed H_R chunk is
        appended and fsync'd *before* its drain dispatches, so a crash
        mid-drain loses nothing that was sealed — :meth:`restore` replays
        the log. Default off: the paper's numbers carry no WAL cost
        unless asked for."""
        try:
            impl = _BACKENDS[backend]
        except KeyError:
            raise ValueError(f"unknown backend {backend!r}; expected one "
                             f"of {tuple(_BACKENDS)}") from None
        wal = kw.pop("wal", None)
        if wal is not None and not hasattr(wal, "append_seal"):
            from .wal import WriteAheadLog
            wal = WriteAheadLog(wal)
        kw["wal"] = wal
        if backend == "sim":
            if device is not None:
                raise ValueError("the sim backend runs on the host; it "
                                 "takes no device")
            return cls(impl(**kw) if config is None
                       else impl(geom=config, **kw))
        kw["device"] = "cuda" if device is None else device
        return cls(impl(**kw) if config is None else impl(cfg=config, **kw))

    # -- lifecycle ----------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("store is closed")

    def close(self) -> None:
        """Flush (durability point) and release the store; idempotent.
        If the final flush fails, the error propagates but the worker is
        still joined, the WAL closed and the store still ends closed."""
        if self._closed:
            return
        try:
            self._b.flush(wait=True)
        finally:
            self._b.close()
            if self._b.front.wal is not None:
                self._b.front.wal.close()
            self._closed = True

    def __enter__(self) -> "FlashStore":
        self._check_open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # an exception mid-stream still drains H_R: buffered counts are
        # the caller's data, not scratch
        self.close()

    # -- writes -------------------------------------------------------------
    def update(self, tokens, deltas=None) -> None:
        """Accumulate a (token[, Δ]) batch into H_R. Duplicates fold,
        zero-sum Δs cancel (§2.6), EMPTY tokens are padding; the device
        sees traffic only at flush thresholds."""
        self._check_open()
        self._b.update(tokens, deltas)

    def increment(self, key: int, delta: int = 1) -> None:
        """Single-key counter bump; ``delta=-1`` is the paper's
        deletion-by-decrement."""
        self.update(np.asarray([key], np.int64),
                    np.asarray([delta], np.int64))

    def flush(self, wait: bool = True) -> None:
        """Durability point: drain H_R and force the device merge of any
        staged change segment. ``wait=True`` is the barrier; ``wait=False``
        schedules the work on the background worker. A flush with nothing
        buffered, in flight or staged is a complete no-op."""
        self._check_open()
        self._b.flush(wait=wait)

    def drain(self, wait: bool = True) -> None:
        """Stage H_R to the device change segment without forcing the
        merge (the cheap half of :meth:`flush`)."""
        self._check_open()
        self._b.drain(wait=wait)

    # -- reads --------------------------------------------------------------
    def query(self, keys):
        """Counts for ``keys`` — scalar in, ``int`` out; array-like in,
        ``int64`` array out. Reads see buffered H_R deltas."""
        self._check_open()
        if np.isscalar(keys) or (isinstance(keys, np.ndarray)
                                 and keys.ndim == 0):
            return int(self._b.query_batch(np.asarray([keys]))[0])
        return self._b.query_batch(keys)

    def query_batch(self, keys) -> np.ndarray:
        """Alias of :meth:`query` for batched call sites."""
        self._check_open()
        return self._b.query_batch(keys)

    # -- introspection ------------------------------------------------------
    @property
    def backend(self) -> str:
        return self._b.name

    @property
    def scheme(self) -> str:
        return self._b.scheme

    @property
    def cfg(self):
        """The device table's config (None for the sim)."""
        return getattr(self._b, "cfg", None)

    @property
    def state(self):
        """Device table state (None for the sim)."""
        return getattr(self._b, "state", None)

    @property
    def buffered_entries(self) -> int:
        return self._b.pending_entries()

    def stats(self) -> Dict[str, int]:
        """One flat ledger: device wear (``tile_stores`` = paper cleans)
        plus ``write_*`` and ``query_*`` counters. Barriers any in-flight
        drain first."""
        return self._b.stats()

    def wear(self) -> Dict[str, int]:
        """The ``TableStats`` counters (``tile_stores`` = paper cleans)."""
        return self._b.wear()

    def partition_heat(self, keys) -> np.ndarray:
        """Per-key wear heat of the key's partition (``track_wear=True``;
        zeros otherwise)."""
        return self._b.partition_heat(keys)

    # -- durability: snapshot / restore (DESIGN.md §11) ----------------------
    @property
    def wal(self):
        """The attached :class:`~.wal.WriteAheadLog` (None without one)."""
        return self._b.front.wal

    def quiesce(self) -> None:
        """Join any in-flight drain without forcing new device traffic, so
        a snapshot never captures a state mid-drain. Raises if the store
        is poisoned (the snapshot would be missing a sealed chunk)."""
        self._check_open()
        self._b.front.settle()

    def snapshot(self, path, step: Optional[int] = None,
                 extra_meta: Optional[Dict] = None, manager=None) -> Path:
        """Durability capture: flush everything (drain + device merge,
        the barrier), write the device/sim state through the checkpoint
        layout under ``path``, then **rotate** the WAL — every logged
        chunk is now redundant with the snapshot. Returns the snapshot
        directory.

        ``step`` defaults to one past the latest snapshot under ``path``
        (0 for the first). ``extra_meta`` rides along in ``meta.json``
        (e.g. ``CorpusStats`` counters)."""
        self._check_open()
        if manager is not None:
            raise NotImplementedError(_NO_MANAGER)
        from ..checkpoint.checkpoint import latest_step
        self._b.flush(wait=True)
        wal = self._b.front.wal
        base = wal.last_seq if wal is not None else 0
        if step is None:
            latest = latest_step(path)
            step = 0 if latest is None else latest + 1
        meta = {"wal_base_seq": base, "store_backend": self.backend,
                "store_scheme": self.scheme}
        meta.update(extra_meta or {})
        out = self._b.snapshot_state(path, step, meta)
        if wal is not None:
            wal.rotate()
        return out

    def restore(self, path=None, step: Optional[int] = None
                ) -> RestoreReport:
        """Recover to the last durable state: drop every buffer (clearing
        any poison), re-arm the drain worker, load the latest snapshot
        under ``path`` (fresh-init when ``path`` is None or holds no
        snapshot), then replay sealed-but-uncovered WAL records — seqs
        after the snapshot's ``wal_base_seq`` — through the normal update
        path (appends suppressed, so restoring twice is idempotent).

        The recovery contract: after ``restore()``, the store holds
        exactly the deltas that were sealed before the crash — no lost
        chunks (seal fsyncs before dispatch), no double-applied chunks
        (the snapshot rotates the log; replay reapplies onto the
        snapshot, or onto a fresh table covering seq 0; the log numbers
        new seals past the snapshot's base even when it was reopened
        empty after a rotation). Entries that
        were still in the *active* buffer (never sealed) are the one
        permissible loss — exactly the paper's H_R volatility window."""
        b = self._b
        try:
            b._disp.wait()            # settle what can settle; poison is
        except DrainError:
            pass                      # cleared below, not re-raised here
        poisoned = b.front.poisoned
        b.rearm()
        b.front.clear()
        self._closed = False          # restore reopens a closed store
        snap_step, snap_meta = b.restore_state(path, step)
        base = int(snap_meta.get("wal_base_seq", 0))
        records_replayed = entries_replayed = 0
        discarded = 0
        wal = b.front.wal
        if wal is not None:
            from .wal import SEAL, WriteAheadLog, read_wal
            if wal.closed:            # restoring a closed store: reopen
                wal = WriteAheadLog(wal.path, fsync=wal.fsync)
                b.front.wal = wal
            wal.resume_after(base)    # new seals replay past the base
            records, discarded = read_wal(wal.path)
            seals = sorted((r for r in records
                            if r.kind == SEAL and r.seq > base),
                           key=lambda r: r.seq)
            with wal.suppressed():
                for r in seals:
                    b.update(r.keys, r.deltas)
                    records_replayed += 1
                    entries_replayed += int(r.keys.size)
                # several processes: drain() is collective, so every rank
                # calls it, with or without seal records of its own (the
                # per-host WALs recover independently, drain in lockstep)
                if seals or getattr(b, "multihost", False):
                    b.drain(wait=True)
        return RestoreReport(
            snapshot_step=snap_step, base_seq=base,
            records_replayed=records_replayed,
            entries_replayed=entries_replayed,
            tail_discarded_bytes=discarded, poison_cleared=poisoned,
            meta=snap_meta)


__all__ = ["FlashStore", "FlushDispatcher", "DrainError", "SealedFront",
           "RestoreReport", "SimBackend", "DeviceBackend", "ShardedBackend",
           "EMPTY"]
