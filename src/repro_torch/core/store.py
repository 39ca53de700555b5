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

Two backends plug in behind the same lifecycle:

* ``device`` — a :class:`~.write_engine.BatchedWriteEngine` paired with a
  :class:`~.query_engine.BatchedQueryEngine` over the device table (the
  card by default, ``device="cpu"`` for the kernels' plain versions); the
  flush → invalidate contract is enforced here, never by callers. Engine
  pairing happens only in this module.
* ``sim`` — the event-level numpy simulator (:mod:`.table_sim`, the
  paper's SSD cost ledger) on the host. It takes no device.

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

    * **fold** — (token, Δ) pairs accumulate in the *active* buffer;
    * **settle** — wait out the in-flight drain; a sealed chunk still
      present *after* the barrier means its drain died, so the front is
      **poisoned**: writes fail loudly rather than silently dropping the
      chunk, and reads keep overlaying it;
    * **seal** — post-settle, the active buffer swaps for a fresh one and
      becomes the read-only *in-flight* overlay; the sealed ``(keys,
      Δs)`` arrays (sorted, deterministic order) go to the caller. With a
      WAL attached, the sealed chunk is appended and fsync'd here —
      **before** the caller submits its drain — so a crash mid-drain
      loses nothing that was sealed;
    * **mark_drained** — worker side, under the dispatcher lock: the
      delivered overlay clears, atomically with the device state rebind,
      and the drain's commit record is logged.

    ``FlashStore.restore()`` is the way out of the poisoned state
    (:meth:`clear` drops every buffer; the WAL replay re-delivers them).
    """

    # shared with the drain worker; flashlint FL006 holds every access
    # to the state lock (or an audited under-lock/quiescent method)
    _fl_guarded = ("_inflight",)

    def __init__(self, dispatcher: Optional[FlushDispatcher] = None,
                 wal=None):
        self.dispatcher = dispatcher
        self.wal = wal
        self._buf: Dict[int, int] = {}
        # the sealed-but-draining chunk: the worker clears it (under the
        # dispatcher lock) once its entries are on device
        self._inflight: Optional[Dict[int, int]] = None
        self._wal_seq: Optional[int] = None   # the in-flight chunk's seq
        self.seals = 0

    # -- ingest side ---------------------------------------------------------
    def fold(self, uniq: np.ndarray, sums: np.ndarray) -> Tuple[int, int]:
        """Fold pre-deduped (token, Δ-sum) pairs into the active buffer.
        Returns ``(n_new_slots, n_cancelled)`` for the caller's ledger."""
        from .write_engine import fold_entry
        n_new = cancelled = 0
        buf = self._buf
        for k, s in zip(uniq.tolist(), sums.tolist()):
            opened = fold_entry(buf, k, s)
            if opened > 0:
                n_new += 1
            elif opened < 0:
                cancelled += 1
        return n_new, cancelled

    def active_len(self) -> int:
        """Active-buffer size (threshold decisions)."""
        return len(self._buf)

    # -- lifecycle -----------------------------------------------------------
    def settle(self) -> None:
        """Barrier the in-flight drain, then fail loudly if it died (the
        pre-barrier probe is a benign unlocked read)."""
        d = self.dispatcher
        if (self._inflight is not None        # flashlint: disable=FL006
                or (d is not None and d.pending)):
            if d is not None:
                d.wait()
        if self._inflight is not None:        # flashlint: disable=FL006
            raise RuntimeError(
                "store is poisoned: a drain failed and its sealed H_R "
                "chunk was never delivered — reopen from the last durable "
                "state (FlashStore.restore() clears the poison and "
                "replays the WAL)")

    # flashlint: quiescent (callers settle first; see the class docstring)
    def seal(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Swap the active buffer into the in-flight overlay; returns the
        sealed ``(sorted keys, deltas)`` or ``None`` when nothing is
        buffered. With a WAL, the chunk is logged and one fsync lands
        before this returns."""
        if not self._buf:
            return None
        if self._inflight is not None:
            # never clobber a sealed chunk (a failed drain leaves its
            # entries here — they are still the read overlay)
            raise RuntimeError("sealed H_R over an in-flight chunk; wait "
                               "out the previous drain first")
        b = self._buf
        keys = np.fromiter(b.keys(), np.int64, len(b))
        dels = np.fromiter(b.values(), np.int64, len(b))
        order = np.argsort(keys, kind="stable")  # deterministic
        keys, dels = keys[order], dels[order]
        self._inflight = b
        self._buf = {}
        self.seals += 1
        if self.wal is not None:
            self._wal_seq = self.wal.append_seal(0, keys, dels)
            self.wal.sync()           # durable before the drain dispatches
        return keys, dels

    def mark_drained(self) -> None:  # flashlint: under-lock
        """Worker side, under the dispatcher lock: the sealed chunk is
        really on device — clear its overlay and log the commit."""
        self._inflight = None
        if self.wal is not None and self._wal_seq is not None:
            self.wal.append_commit(0, self._wal_seq)
            self._wal_seq = None

    # -- read-your-writes ----------------------------------------------------
    def pending(self, flat: np.ndarray) -> np.ndarray:
        # flashlint: under-lock
        """Not-yet-durable Δ per key: active + in-flight buffers. Call
        under the dispatcher lock (the worker clears the in-flight chunk
        under it)."""
        buf, inf = self._buf, self._inflight
        if not buf and not inf:
            return np.zeros(flat.size, np.int64)
        if inf:
            return np.fromiter(
                (buf.get(int(k), 0) + inf.get(int(k), 0) for k in flat),
                np.int64, flat.size)
        return np.fromiter((buf.get(int(k), 0) for k in flat),
                           np.int64, flat.size)

    def buffers(self) -> List[Dict[int, int]]:  # flashlint: under-lock
        """The active and in-flight buffers that hold entries."""
        return [b for b in (self._buf, self._inflight) if b]

    def entries(self) -> int:
        # benign unlocked snapshot (monitoring only, may be momentarily
        # stale); never used for control flow
        inf = self._inflight                  # flashlint: disable=FL006
        return len(self._buf) + (len(inf) if inf else 0)

    @property
    def poisoned(self) -> bool:
        """An undelivered sealed chunk survives the barrier (benign
        unlocked probe: only consulted on quiesced paths)."""
        return self._inflight is not None     # flashlint: disable=FL006

    def clear(self) -> None:  # flashlint: quiescent (restore path, re-armed)
        """Drop both buffers, clearing any poison. Only the restore path
        calls this, after re-arming the dispatcher: the dropped entries
        are exactly what the WAL replay re-delivers."""
        self._buf = {}
        self._inflight = None
        self._wal_seq = None


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
        if self.front.active_len() >= self.flush_threshold:
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

    def drain(self, wait: bool = True) -> None:
        self.front.settle()
        sealed = self.front.seal()
        if sealed is not None:
            k, d = sealed
            self._disp.submit(lambda: self._replay(k, d, merge=False),
                              label=f"sim-drain#{self.front.seals}:"
                                    f"{k.size}e")
        if wait:
            self._disp.wait()

    def flush(self, wait: bool = True) -> None:  # durability point
        self.front.settle()
        sealed = self.front.seal()
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


_BACKENDS = {"sim": SimBackend, "device": DeviceBackend}


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
        """One constructor for both backends.

        ``config`` is backend-shaped — a ``TableGeometry`` for ``sim``, a
        ``FlashTableConfig`` for ``device`` — or ``None`` to build one
        from ``**kw`` (``scheme=``, ``q_log2=``, ...). Engine knobs
        (``chunk``, ``flush_threshold``, ``query_chunk``,
        ``hot_capacity``, ``async_flush``, ...) pass through as keywords.
        The device table lives on ``device``: the card by default
        (raising when there is none), ``"cpu"`` for the plain versions of
        the kernels. The sim runs on the host and takes no ``device``.

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
                if seals:
                    b.drain(wait=True)
        return RestoreReport(
            snapshot_step=snap_step, base_seq=base,
            records_replayed=records_replayed,
            entries_replayed=entries_replayed,
            tail_discarded_bytes=discarded, poison_cleared=poisoned,
            meta=snap_meta)


__all__ = ["FlashStore", "FlushDispatcher", "DrainError", "SealedFront",
           "RestoreReport", "SimBackend", "DeviceBackend", "EMPTY"]
