"""`FlashStore`: the one facade over the device flash-hash table.

The paper's central claim is that one deferred-update discipline — RAM
buffer H_R in front, semi-random block-local merges behind — serves every
scheme variant (§2, Fig 4). `FlashStore` is the single entry point:

    with FlashStore.open(scheme="MDB-L") as store:   # on the card
        store.update(tokens)            # buffered in H_R
        store.increment(key, -1)        # deletion-by-decrement (§2.6)
        counts = store.query(keys)      # read-your-writes, batched
        store.flush()                   # durability point: drain + merge
        print(store.stats())

The ``device`` backend pairs a :class:`~.write_engine.BatchedWriteEngine`
with a :class:`~.query_engine.BatchedQueryEngine`; the flush → invalidate
contract is enforced here, never by callers. Engine pairing happens only
in this module.

Flushes are **asynchronous and double-buffered**: ingest fills an active
H_R buffer while one background worker (a :class:`FlushDispatcher` per
store) drains the sealed one. ``flush(wait=True)`` is the durability
barrier; reads overlay both buffers, so read-your-writes holds at every
instant; ``async_flush=False`` drains inline (the ``stall_us`` ledger
then measures what the async path hides).

The write-ahead log, ``snapshot`` and ``restore`` are not in this
package yet: passing ``wal=`` or calling them raises
``NotImplementedError``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

EMPTY = -1

_NOT_YET = ("the write-ahead log, snapshot and restore are not ported to "
            "the PyTorch package yet (the next slice of the port)")


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
      Δs)`` arrays (sorted, deterministic order) go to the caller;
    * **mark_drained** — worker side, under the dispatcher lock: the
      delivered overlay clears, atomically with the device state rebind.
    """

    # shared with the drain worker; flashlint FL006 holds every access
    # to the state lock (or an audited under-lock/quiescent method)
    _fl_guarded = ("_inflight",)

    def __init__(self, dispatcher: Optional[FlushDispatcher] = None):
        self.dispatcher = dispatcher
        self._buf: Dict[int, int] = {}
        # the sealed-but-draining chunk: the worker clears it (under the
        # dispatcher lock) once its entries are on device
        self._inflight: Optional[Dict[int, int]] = None
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
                "chunk was never delivered — reopen the store")

    # flashlint: quiescent (callers settle first; see the class docstring)
    def seal(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Swap the active buffer into the in-flight overlay; returns the
        sealed ``(sorted keys, deltas)`` or ``None`` when nothing is
        buffered."""
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
        self._inflight = b
        self._buf = {}
        self.seals += 1
        return keys[order], dels[order]

    def mark_drained(self) -> None:  # flashlint: under-lock
        """Worker side, under the dispatcher lock: the sealed chunk is
        really on device — clear its overlay."""
        self._inflight = None

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


# ---------------------------------------------------------------------------
# device backend: single-table engine pair
# ---------------------------------------------------------------------------
class DeviceBackend:
    """The engine pair, auto-wired: one
    :class:`~.write_engine.BatchedWriteEngine` owning the table state,
    one paired :class:`~.query_engine.BatchedQueryEngine`, flush →
    invalidate enforced by construction. With ``track_wear=True`` the
    backend attributes per-drain ``TableStats`` wear deltas
    (Δ``tile_stores``) to change-segment partitions."""

    name = "device"
    # the wear ledger is mutated by _on_drain on the drain worker; FL006
    # holds every access to the state lock or an audited method
    _fl_guarded = ("_wear",)

    def __init__(self, cfg=None, state=None, chunk: int = 4096,
                 query_chunk: int = 1024,
                 flush_threshold: Optional[int] = None,
                 hot_capacity: int = 4096, track_wear: bool = False,
                 async_flush: bool = True, device="cuda", **table_kw):
        from . import table_torch as tt
        from .query_engine import BatchedQueryEngine
        from .write_engine import BatchedWriteEngine, PartitionHeatLedger
        self.cfg = cfg if cfg is not None else tt.FlashTableConfig(**table_kw)
        self.scheme = self.cfg.scheme
        if state is None:
            device = tt.resolve_device(device)
        self.query_engine = BatchedQueryEngine(
            self.cfg, chunk=query_chunk, hot_capacity=hot_capacity,
            filter_fn=((lambda state, q: tt.filter_probe(self.cfg, state, q))
                       if self.cfg.filters else None))
        self._track_wear = bool(track_wear)
        self._disp = FlushDispatcher(enabled=async_flush)
        self.writer = BatchedWriteEngine(
            self.cfg, state=state, chunk=chunk,
            flush_threshold=flush_threshold, query_engine=self.query_engine,
            on_flush=self._on_drain if track_wear else None,
            dispatcher=self._disp, device=device)
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

    def close(self) -> None:
        self._disp.close()


_BACKENDS = {"device": DeviceBackend}


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------
class FlashStore:
    """Counting hash table with the paper's deferred-update discipline
    built in. Construct with :meth:`open`; use as a context manager for
    automatic flush-on-exit."""

    def __init__(self, backend_impl):
        self._b = backend_impl
        self._closed = False

    @classmethod
    def open(cls, config=None, backend: str = "device", device="cuda",
             **kw) -> "FlashStore":
        """One constructor. ``config`` is a ``FlashTableConfig`` or
        ``None`` to build one from ``**kw`` (``scheme=``, ``q_log2=``,
        ...). Engine knobs (``chunk``, ``flush_threshold``,
        ``query_chunk``, ``hot_capacity``, ``async_flush``, ...) pass
        through as keywords. The table lives on ``device``: the card by
        default (raising when there is none), ``"cpu"`` for the plain
        versions of the kernels."""
        try:
            impl = _BACKENDS[backend]
        except KeyError:
            raise ValueError(f"unknown backend {backend!r}; expected one "
                             f"of {tuple(_BACKENDS)}") from None
        if kw.pop("wal", None) is not None:
            raise NotImplementedError(_NOT_YET)
        if config is None:
            return cls(impl(device=device, **kw))
        return cls(impl(cfg=config, device=device, **kw))

    # -- lifecycle ----------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("store is closed")

    def close(self) -> None:
        """Flush (durability point) and release the store; idempotent.
        If the final flush fails, the error propagates but the worker is
        still joined and the store still ends closed."""
        if self._closed:
            return
        try:
            self._b.flush(wait=True)
        finally:
            self._b.close()
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
        return self._b.cfg

    @property
    def state(self):
        """Device table state."""
        return self._b.state

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

    # -- durability: not in this package yet ---------------------------------
    def snapshot(self, path, step=None, extra_meta=None, manager=None):
        raise NotImplementedError(_NOT_YET)

    def restore(self, path=None, step=None):
        raise NotImplementedError(_NOT_YET)


__all__ = ["FlashStore", "FlushDispatcher", "DrainError", "SealedFront",
           "DeviceBackend", "EMPTY"]
