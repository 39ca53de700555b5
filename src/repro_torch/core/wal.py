"""Chunk-granular write-ahead log for the store's H_R front (DESIGN.md §11).

The paper's H_R buffer (§2.2) makes writes fast precisely by keeping
recent deltas out of flash — so a crash mid-drain loses exactly the data
the design worked hardest to batch. FAWN-style log-structured stores
treat the RAM front as recoverable-by-construction: append the sealed
chunk to a log *before* dispatching it, and replay the log after a
crash. The :class:`~.store.SealedFront` lifecycle gives the log a
natural granularity — one record per sealed H_R chunk, appended and
fsync'd at seal time (before the drain is even submitted), plus one
commit record when the drain worker delivers it.

Record format (binary, little-endian, after an 8-byte ``FLWAL001``
magic)::

    <u32 crc32> <u8 type> <i32 part> <u64 seq> <u32 n>
    n × <i64 key> , n × <i64 delta>          (SEAL records only)

``crc32`` covers everything after itself (type..payload), so a torn
final write — header or payload cut short by a crash — is detected and
discarded loudly instead of replayed as garbage. ``part`` is the H_R
partition (0 for single-table fronts, the owner shard for the sharded
store), which is what lets an elastic restart re-own a departing
shard's partition by filtering the log. ``seq`` is monotonic
per file and never reused: a snapshot records the last sealed ``seq``
it covers (``wal_base_seq``) and replay applies only records after it.

Durability points:

* **seal** — every sealed part appends one SEAL record; one ``fsync``
  per seal *event* (covering all parts sealed together) lands before
  the drain is submitted. A chunk the caller saw sealed is recoverable.
* **commit** — the drain worker appends a COMMIT for each delivered
  part (no fsync: losing a commit only means idempotent replay work).
* **rotate** — ``FlashStore.snapshot()`` quiesces, captures the device
  state, then truncates the log: every record is now redundant with the
  snapshot. Plain merges do *not* rotate — device state is volatile
  until a snapshot captures it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import struct
# the log is appended from both the caller (seal) and the drain worker
# (commit); it carries its own lock rather than borrowing the
# dispatcher's so a WAL append can never extend the state lock's hold
# time. flashlint FL004 allows this module explicitly.
import threading
import warnings
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

MAGIC = b"FLWAL001"
SEAL = 1      # a sealed H_R chunk: payload = keys + deltas
COMMIT = 2    # drain completion for an earlier SEAL's seq (no payload)

_HDR = struct.Struct("<BiQI")      # type, part, seq, n  (crc32 prepended)
_CRC = struct.Struct("<I")


@dataclasses.dataclass
class WalRecord:
    """One decoded log record (``keys``/``deltas`` are None for COMMIT)."""

    kind: int
    part: int
    seq: int
    keys: Optional[np.ndarray]
    deltas: Optional[np.ndarray]


def _encode(kind: int, part: int, seq: int,
            keys: Optional[np.ndarray],
            deltas: Optional[np.ndarray]) -> bytes:
    n = 0 if keys is None else int(keys.size)
    body = _HDR.pack(kind, part, seq, n)
    if n:
        body += np.ascontiguousarray(keys, "<i8").tobytes()
        body += np.ascontiguousarray(deltas, "<i8").tobytes()
    return _CRC.pack(zlib.crc32(body)) + body


def read_wal(path) -> Tuple[List[WalRecord], int]:
    """Decode every intact record of ``path``; returns
    ``(records, discarded_tail_bytes)``.

    A non-record-aligned tail (torn final write: short header, short
    payload, or CRC mismatch) is discarded **loudly** — a ``UserWarning``
    names the file and byte count — and everything before it is kept:
    records are appended strictly in order, so the first bad byte ends
    the recoverable prefix. A missing file reads as empty."""
    path = Path(path)
    if not path.exists():
        return [], 0
    blob = path.read_bytes()
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: not a FlashStore WAL "
                         f"(bad magic {blob[:8]!r})")
    out: List[WalRecord] = []
    off = len(MAGIC)
    while off < len(blob):
        start = off
        hdr_end = off + _CRC.size + _HDR.size
        if hdr_end > len(blob):
            break                     # torn header
        (crc,) = _CRC.unpack_from(blob, off)
        kind, part, seq, n = _HDR.unpack_from(blob, off + _CRC.size)
        end = hdr_end + 16 * n        # two i64 arrays of n entries
        if kind not in (SEAL, COMMIT) or end > len(blob):
            break                     # torn/garbage payload
        if zlib.crc32(blob[off + _CRC.size:end]) != crc:
            break                     # corrupt record
        keys = deltas = None
        if n:
            keys = np.frombuffer(blob, "<i8", n, hdr_end).astype(np.int64)
            deltas = np.frombuffer(blob, "<i8", n,
                                   hdr_end + 8 * n).astype(np.int64)
        out.append(WalRecord(kind, part, seq, keys, deltas))
        off = end
    discarded = len(blob) - off
    if discarded:
        warnings.warn(
            f"{path}: discarding {discarded} bytes of torn WAL tail after "
            f"{len(out)} intact records (record at offset {start} is "
            "truncated or corrupt — its seal never completed and is not "
            "recoverable)", stacklevel=2)
    return out, discarded


class WriteAheadLog:
    """Append-side handle: sequenced seal/commit records, one fsync per
    seal event, replay suppression, and snapshot rotation.

    Opening an existing file resumes sequencing after its last intact
    record; a torn tail is truncated (with the :func:`read_wal` warning)
    so new appends land on a clean record boundary."""

    def __init__(self, path, fsync: bool = True):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._do_fsync = bool(fsync)
        self._suppress = 0
        self._next_seq = 1
        self._sealed: set = set()
        self._commits: set = set()
        self._pending_seals = 0
        #: fsync'd seal events so far (a multi-part seal counts once)
        self.seal_events = 0
        #: test/chaos hook: called with ``seal_events`` after each seal
        #: fsync lands — the point "between seal and settle" the chaos
        #: harness SIGKILLs at (tests/helpers/chaos_store_main.py)
        self.after_sync = None
        if self.path.exists() and self.path.stat().st_size > 0:
            records, discarded = read_wal(self.path)
            good = len(MAGIC) + sum(
                _CRC.size + _HDR.size + 16 * (r.keys.size if r.keys
                                              is not None else 0)
                for r in records)
            self._f = open(self.path, "r+b")
            if discarded:
                self._f.truncate(good)   # re-align appends; warned above
            self._f.seek(good)
            for r in records:
                if r.kind == SEAL:
                    self._sealed.add(r.seq)
                else:
                    self._commits.add(r.seq)
                self._next_seq = max(self._next_seq, r.seq + 1)
        else:
            self._f = open(self.path, "w+b")
            self._f.write(MAGIC)
            self._f.flush()

    @property
    def closed(self) -> bool:
        """The file handle is closed (a closed store's log)."""
        return self._f.closed

    @property
    def fsync(self) -> bool:
        """Whether :meth:`sync` fsyncs (``fsync=`` of the constructor)."""
        return self._do_fsync

    # -- watermarks ----------------------------------------------------------
    @property
    def last_seq(self) -> int:
        """Highest seal seq appended (0 when the log is empty)."""
        return self._next_seq - 1

    @property
    def committed_seq(self) -> int:
        """Highest seq with every seal at or below it drain-committed."""
        hi = 0
        for s in sorted(self._sealed):
            if s not in self._commits:
                break
            hi = s
        return hi

    # -- append side ---------------------------------------------------------
    @contextlib.contextmanager
    def suppressed(self):
        """No-op all appends inside the block — the replay path drives
        recovered entries through the normal update/seal machinery, and
        this is what keeps it from re-logging (and therefore makes
        ``restore()`` idempotent)."""
        with self._lock:
            self._suppress += 1
        try:
            yield
        finally:
            with self._lock:
                self._suppress -= 1

    def append_seal(self, part: int, keys: np.ndarray,
                    deltas: np.ndarray) -> Optional[int]:
        """Log one sealed chunk; returns its seq (None when suppressed
        or closed). The caller finishes the seal event with :meth:`sync`
        before dispatching the drain."""
        with self._lock:
            if self._suppress or self._f.closed:
                return None
            seq = self._next_seq
            self._next_seq += 1
            self._f.write(_encode(SEAL, int(part), seq, keys, deltas))
            self._f.flush()           # visible to readers even if killed
            self._sealed.add(seq)
            self._pending_seals += 1
            return seq

    def append_commit(self, part: int, seq: int) -> None:
        """Log a drain completion for seal ``seq`` (worker side). Not
        fsync'd — a lost commit only costs idempotent replay work."""
        with self._lock:
            if self._suppress or self._f.closed or seq is None:
                return
            self._f.write(_encode(COMMIT, int(part), int(seq), None, None))
            self._f.flush()
            self._commits.add(int(seq))

    def sync(self) -> None:
        """Make the current seal event durable: one fsync covering every
        part sealed since the last sync, *before* the drain dispatch."""
        hook = None
        with self._lock:
            if self._f.closed:
                return
            self._f.flush()
            if self._do_fsync:
                os.fsync(self._f.fileno())
            if self._pending_seals:
                self._pending_seals = 0
                self.seal_events += 1
                hook = self.after_sync
        if hook is not None:
            hook(self.seal_events)

    def resume_after(self, seq: int) -> None:
        """Number the next seal after ``seq`` at the least. A restore
        passes its snapshot's ``wal_base_seq``: a log reopened after its
        rotation holds no record and would number from 1 again, and
        replay skips every seal at or below the base."""
        with self._lock:
            self._next_seq = max(self._next_seq, int(seq) + 1)

    # -- lifecycle -----------------------------------------------------------
    def rotate(self) -> None:
        """Truncate the log to empty (snapshot taken: every record is
        redundant with the captured device state). Sequencing continues
        monotonically — seqs are never reused across rotations."""
        with self._lock:
            if self._f.closed:
                return
            self._f.truncate(len(MAGIC))
            self._f.seek(len(MAGIC))
            self._f.flush()
            if self._do_fsync:
                os.fsync(self._f.fileno())
            self._sealed.clear()
            self._commits.clear()
            self._pending_seals = 0

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


__all__ = ["WriteAheadLog", "WalRecord", "read_wal", "SEAL", "COMMIT",
           "MAGIC"]
