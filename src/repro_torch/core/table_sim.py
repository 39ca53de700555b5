"""Event-level simulation of the paper's three hash-table schemes.

A host numpy simulator, as in the reference package: it is the paper's
cost model and the oracle the durability tests recover against, and it
holds no device state.

Faithful functional model of §2 of the paper — the drive-resident *data
segment* is a closed (linear-probing) counting hash table laid out in
blocks/pages; a memory-resident *RAM buffer* (open hash, secondary hash
function ``s``) batches updates; the MDB/MDB-L schemes add an SSD-resident
*change segment*. All device traffic is accounted in a :class:`CostLedger`
(the DiskSim-slave replacement), which the benchmarks convert to time per
SSD configuration.

Schemes
-------
* :class:`MBTable`    — RAM buffer only; flush == block-level merges (§2.3).
* :class:`MDBTable`   — partitioned change segment: each CS block buffers k
  data-segment blocks; stage = semi-random page writes; a full CS block
  triggers a merge of its k data blocks (§2.4).
* :class:`MDBLTable`  — linear log change segment; stage = sequential page
  writes; a full log triggers a global merge (§2.4, MDB-L).
* :class:`NaiveTable` — bufferless baseline of §3.5 (random page writes
  through the FTL GC model).

Counting semantics: ``insert(key, +1)``; deletion-by-decrement
(``delta=-1``); full removal with tombstoning + compaction-on-merge (§2.6).
Linear probing never crosses a block boundary; probe overflow spills to the
page-chained *overflow region* (§2.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .flash_model import CostLedger, TableGeometry
from .hashing import (HashPair, bloom_positions_np, filter_words_for,
                      hash_pair_for)

EMPTY = -1
TOMBSTONE = -2


@dataclasses.dataclass
class QueryStats:
    queries: int = 0
    found: int = 0
    ds_page_reads: int = 0
    cs_block_reads: int = 0
    cs_page_reads: int = 0
    overflow_page_reads: int = 0
    filter_negatives: int = 0  # queries answered by the RAM-resident
                               # Bloom filter with zero flash reads (§12)

    def time_us(self, dev) -> float:
        return ((self.ds_page_reads + self.cs_page_reads +
                 self.overflow_page_reads) * dev.page_read_us
                + self.cs_block_reads * dev.block_read_us)

    def avg_time_ms(self, dev) -> float:
        return self.time_us(dev) / max(self.queries, 1) / 1000.0


class _DataSegment:
    """Closed hash table on the device: blocks of linear-probed entries,
    plus the page-chained overflow region (§2.5)."""

    def __init__(self, geom: TableGeometry, pair: HashPair,
                 ledger: CostLedger, overflow_blocks: int = 1):
        assert pair.q == geom.total_entries and pair.r == geom.block_entries
        self.geom = geom
        self.pair = pair
        self.ledger = ledger
        q = geom.total_entries
        self.keys = np.full(q, EMPTY, dtype=np.int64)
        self.counts = np.zeros(q, dtype=np.int64)
        # position index mirrors the on-device layout; lets the simulation
        # skip O(r) scans per op while still accounting exact probe spans.
        self.index: Dict[int, int] = {}
        # overflow region: entries stored past the main table, page-chained.
        self.overflow_capacity = (overflow_blocks * geom.pages_per_block
                                  * geom.entries_per_page)
        self.ov_keys: List[int] = []
        self.ov_counts: List[int] = []
        self.ov_index: Dict[int, int] = {}
        # per-block number of overflow entries (for query chain-read costs)
        self.block_overflow: Dict[int, int] = {}
        self.tombstones: Dict[int, int] = {}  # block -> count

    # -- geometry helpers -------------------------------------------------
    def block_range(self, b: int):
        r = self.geom.block_entries
        return b * r, (b + 1) * r

    # -- in-memory application of one staged item (costs accounted by caller
    #    at block granularity, exactly like the paper's merge) -------------
    def apply(self, key: int, delta: int) -> None:
        pos = self.index.get(key)
        if pos is not None:
            self.counts[pos] += delta
            return
        ovpos = self.ov_index.get(key)
        if ovpos is not None:
            self.ov_counts[ovpos] += delta
            return
        self._insert_new(key, delta)

    def _insert_new(self, key: int, delta: int) -> None:
        home = int(self.pair.g(key))
        b = home // self.geom.block_entries
        lo, hi = self.block_range(b)
        # first empty slot at or after home, cyclic *within the block* (§2.5)
        free_after = np.flatnonzero(self.keys[home:hi] == EMPTY)
        if free_after.size:
            pos = home + int(free_after[0])
        else:
            free_before = np.flatnonzero(self.keys[lo:home] == EMPTY)
            if free_before.size:
                pos = lo + int(free_before[0])
            else:
                self._insert_overflow(b, key, delta)
                return
        self.keys[pos] = key
        self.counts[pos] = delta
        self.index[key] = pos

    def _insert_overflow(self, b: int, key: int, delta: int) -> None:
        if len(self.ov_keys) >= self.overflow_capacity:
            raise RuntimeError("overflow region exhausted; grow the table")
        self.ov_index[key] = len(self.ov_keys)
        self.ov_keys.append(key)
        self.ov_counts.append(delta)
        self.block_overflow[b] = self.block_overflow.get(b, 0) + 1

    # -- §2.6 removal + compaction ---------------------------------------
    def remove(self, key: int) -> bool:
        pos = self.index.pop(key, None)
        if pos is not None:
            self.keys[pos] = TOMBSTONE
            self.counts[pos] = 0
            b = pos // self.geom.block_entries
            self.tombstones[b] = self.tombstones.get(b, 0) + 1
            return True
        ovpos = self.ov_index.pop(key, None)
        if ovpos is not None:
            self.ov_keys[ovpos] = TOMBSTONE
            self.ov_counts[ovpos] = 0
            return True
        return False

    def compact_block(self, b: int) -> None:
        """Re-hash a block in memory, dropping tombstones (done during merge;
        the block read/write is already accounted by the merge)."""
        if not self.tombstones.get(b):
            return
        lo, hi = self.block_range(b)
        live = [(int(k), int(c)) for k, c in
                zip(self.keys[lo:hi], self.counts[lo:hi]) if k >= 0]
        self.keys[lo:hi] = EMPTY
        self.counts[lo:hi] = 0
        for k, _ in live:
            self.index.pop(k, None)
        self.tombstones.pop(b, None)
        for k, c in live:
            self.apply(k, c)

    # -- query cost model --------------------------------------------------
    def probe_cost_pages(self, key: int):
        """(found, count, ds_pages, ov_pages) for a point query (§2.7)."""
        home = int(self.pair.g(key))
        b = home // self.geom.block_entries
        epp = self.geom.entries_per_page
        pos = self.index.get(key)
        if pos is not None:
            if pos >= home:
                span = pos - home
            else:  # wrapped within block
                lo, hi = self.block_range(b)
                span = (hi - home) + (pos - lo)
            return True, int(self.counts[pos]), span // epp + 1, 0
        ovpos = self.ov_index.get(key)
        if ovpos is not None:
            # read the home block pages up to the block end, then chase the
            # overflow page chain for this block
            lo, hi = self.block_range(b)
            ds_pages = (hi - home) // epp + 1
            ov_pages = self.block_overflow.get(b, 0) // epp + 1
            return True, int(self.ov_counts[ovpos]), ds_pages, ov_pages
        # absent: probe to the first empty slot
        lo, hi = self.block_range(b)
        free_after = np.flatnonzero(self.keys[home:hi] == EMPTY)
        if free_after.size:
            span = int(free_after[0])
            return False, 0, span // epp + 1, 0
        free_before = np.flatnonzero(self.keys[lo:home] == EMPTY)
        if free_before.size:
            span = (hi - home) + int(free_before[0])
            ov_pages = 0
        else:
            span = hi - home
            ov_pages = self.block_overflow.get(b, 0) // epp + 1
        return False, 0, span // epp + 1, ov_pages

    def total_count(self, key: int) -> int:
        pos = self.index.get(key)
        if pos is not None:
            return int(self.counts[pos])
        ovpos = self.ov_index.get(key)
        if ovpos is not None:
            return int(self.ov_counts[ovpos])
        return 0

    @property
    def load_factor(self) -> float:
        return len(self.index) / self.geom.total_entries


class _RamBuffer:
    """Open secondary hash table H_R: slot m buffers block m's updates."""

    def __init__(self, pair: HashPair, capacity_entries: int):
        self.pair = pair
        self.capacity = max(int(capacity_entries), 1)
        self.items: Dict[int, int] = {}  # key -> accumulated delta

    def add(self, key: int, delta: int) -> None:
        new = self.items.get(key, 0) + delta
        if new == 0 and key in self.items:
            # paper §2.6: zero-frequency entries are not retained in memory
            del self.items[key]
        else:
            self.items[key] = new

    def add_batch(self, keys: np.ndarray, deltas: Optional[np.ndarray] = None):
        if deltas is None:
            uniq, cnt = np.unique(keys, return_counts=True)
            for k, c in zip(uniq.tolist(), cnt.tolist()):
                self.add(k, c)
        else:
            order = np.argsort(keys, kind="stable")
            ks, ds = keys[order], deltas[order]
            bounds = np.flatnonzero(np.diff(ks)) + 1
            sums = np.add.reduceat(ds, np.r_[0, bounds])
            for k, d in zip(ks[np.r_[0, bounds]].tolist(), sums.tolist()):
                if d:
                    self.add(int(k), int(d))

    @property
    def full(self) -> bool:
        return len(self.items) >= self.capacity

    def get(self, key: int) -> int:
        return self.items.get(key, 0)

    def drain_by_block(self) -> Dict[int, List]:
        """Group buffered items by destination block (slot id) and clear."""
        if not self.items:
            return {}
        keys = np.fromiter(self.items.keys(), dtype=np.int64,
                           count=len(self.items))
        deltas = np.fromiter(self.items.values(), dtype=np.int64,
                             count=len(self.items))
        blocks = self.pair.s(keys)
        order = np.argsort(blocks, kind="stable")
        keys, deltas, blocks = keys[order], deltas[order], blocks[order]
        out: Dict[int, List] = {}
        bounds = np.flatnonzero(np.diff(blocks)) + 1
        starts = np.r_[0, bounds]
        ends = np.r_[bounds, len(blocks)]
        for s, e in zip(starts.tolist(), ends.tolist()):
            out[int(blocks[s])] = [keys[s:e], deltas[s:e]]
        self.items = {}
        return out


class _BlockedBloom:
    """RAM-resident per-block Bloom filter array — the event-level twin of
    the device table's ``filter_words`` (DESIGN.md §12). Same geometry
    (:func:`filter_words_for`), same hash (:func:`bloom_positions_np`, the
    numpy twin of the device path's :func:`bloom_positions`), same
    monotone-OR discipline: bits are only ever set, when keys become
    flash-visible at a drain. ``remove()`` leaves stale positives behind
    (conservative — a false positive costs a probe, never correctness)."""

    def __init__(self, num_blocks: int, block_entries: int):
        fw = filter_words_for(block_entries)
        self.bits_log2 = (fw * 32).bit_length() - 1
        self.words = np.zeros((num_blocks, fw), dtype=np.uint32)

    def add_batch(self, block: int, keys: np.ndarray) -> None:
        row = self.words[block]
        for p in bloom_positions_np(np.asarray(keys, np.int64),
                                    self.bits_log2):
            np.bitwise_or.at(row, (p >> np.uint32(5)).astype(np.int64),
                             np.left_shift(np.uint32(1),
                                           p & np.uint32(31)))

    def may_contain(self, block: int, key: int) -> bool:
        row = self.words[block]
        for p in bloom_positions_np(np.asarray([key], np.int64),
                                    self.bits_log2):
            i = int(p[0])
            if not (int(row[i >> 5]) >> (i & 31)) & 1:
                return False
        return True


class FlashHashTableBase:
    """Shared machinery: insert/update/delete path, RAM buffer, merges."""

    scheme = "?"

    def __init__(self, geom: TableGeometry, ram_buffer_pct: float,
                 a: Optional[int] = None, overflow_blocks: int = 1,
                 filters: bool = True):
        self.geom = geom
        kwargs = {} if a is None else {"a": a}
        self.pair = hash_pair_for(geom.num_blocks, geom.block_entries, **kwargs)
        self.ledger = CostLedger(_pages_per_block=geom.pages_per_block)
        self.ds = _DataSegment(geom, self.pair, self.ledger, overflow_blocks)
        cap = int(ram_buffer_pct / 100.0 * geom.total_entries)
        self.ram = _RamBuffer(self.pair, cap)
        self.filters = (_BlockedBloom(geom.num_blocks, geom.block_entries)
                        if filters else None)
        self.qstats = QueryStats()

    # -- element insertion / update / deletion (§2.5, §2.6) ---------------
    def insert(self, key: int, delta: int = 1) -> None:
        self.ram.add(int(key), int(delta))
        if self.ram.full:
            self.flush()

    def insert_batch(self, keys: np.ndarray,
                     deltas: Optional[np.ndarray] = None,
                     chunk: Optional[int] = None) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        if chunk is None:
            # granularity tied to the RAM buffer so the flush threshold is
            # honored within ~25% (element-wise inserts would be exact but
            # O(python) slow; the paper's event loop is per-record)
            chunk = int(min(max(self.ram.capacity // 4, 16), 16384))
        for i in range(0, len(keys), chunk):
            self.ram.add_batch(keys[i:i + chunk],
                               None if deltas is None else deltas[i:i + chunk])
            if self.ram.full:
                self.flush()

    def delete(self, key: int) -> None:
        """Deletion-by-decrement (paper §2.6, first kind)."""
        self.insert(key, -1)

    def remove(self, key: int) -> bool:
        """Full removal (paper §2.6, second kind): drop any buffered delta,
        tombstone the drive entry; compaction happens at next merge."""
        self.ram.items.pop(int(key), None)
        self._remove_staged(int(key))
        return self.ds.remove(int(key))

    def _remove_staged(self, key: int) -> None:
        pass  # overridden by change-segment schemes

    # -- scheme hooks -------------------------------------------------------
    def flush(self) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        """Push everything to the data segment (end-of-run)."""
        raise NotImplementedError

    # -- RAM drain + Bloom maintenance --------------------------------------
    def _drain(self) -> Dict[int, List]:
        """``ram.drain_by_block()`` plus filter maintenance: this boundary
        is where keys become flash-visible (staged or merged), so their
        Bloom bits are OR'd in here — before that the RAM buffer itself
        answers them, after that the bits cover them forever (monotone)."""
        groups = self.ram.drain_by_block()
        if self.filters is not None:
            for b, (keys, _deltas) in groups.items():
                self.filters.add_batch(b, keys)
        return groups

    # -- merge helper: one data-segment block ------------------------------
    def _merge_block(self, b: int, keys: np.ndarray, deltas: np.ndarray):
        self.ledger.read_block()
        self.ds.compact_block(b)
        for k, d in zip(keys.tolist(), deltas.tolist()):
            self.ds.apply(int(k), int(d))
        self.ledger.write_block()  # erase-before-write accounted inside

    # -- queries (§2.7) -----------------------------------------------------
    def query(self, key: int) -> int:
        key = int(key)
        if (self.filters is not None
                and not self.filters.may_contain(int(self.pair.s(key)), key)):
            # definitive miss on all of data / change / overflow: only the
            # RAM buffer can still hold the key; zero flash reads accrue
            total = self.ram.get(key)
            self.qstats.queries += 1
            self.qstats.filter_negatives += 1
            if total != 0:
                self.qstats.found += 1
            return total
        total = self.ram.get(key)                    # negligible cost
        total += self._query_change_segment(key)     # scheme-specific cost
        found, cnt, ds_pages, ov_pages = self.ds.probe_cost_pages(key)
        self.qstats.queries += 1
        self.qstats.ds_page_reads += ds_pages
        self.qstats.overflow_page_reads += ov_pages
        total += cnt
        if total != 0 or found:
            self.qstats.found += 1
        return total

    def _query_change_segment(self, key: int) -> int:
        return 0

    def query_batch(self, keys) -> np.ndarray:
        """Batched counts — API twin of the device adapter's batched
        path. The event-level simulation still accounts each key's SSD
        cost individually (the paper's per-query ledger); batching here
        is an interface property, not a cost model change. EMPTY
        padding keys return 0 at no cost, matching the device engine."""
        flat = np.asarray(keys).reshape(-1)
        return np.fromiter(
            (self.query(int(k)) if k != EMPTY else 0 for k in flat),
            dtype=np.int64, count=flat.size)

    def update_batch(self, keys, deltas: Optional[np.ndarray] = None) -> None:
        """Batched (token, Δ) writes — API twin of the device write
        engine's dispatch chunks. Accepts the engine's EMPTY-padded
        fixed-shape layout: EMPTY keys are padding and are ignored at no
        cost, and explicit deltas carry counting semantics (±Δ,
        deletion-by-decrement). This keeps the event-level sim a drop-in
        oracle for workloads driven through ``BatchedWriteEngine``."""
        flat = np.asarray(keys).reshape(-1).astype(np.int64)
        if deltas is None:
            d = np.ones(flat.size, dtype=np.int64)
        else:
            d = np.asarray(deltas).reshape(-1).astype(np.int64)
            if d.size != flat.size:
                raise ValueError(f"deltas size {d.size} != keys {flat.size}")
        m = flat != EMPTY
        if m.any():
            self.insert_batch(flat[m], d[m])

    # convenience for tests: exact logical count, no cost accounting
    def logical_count(self, key: int) -> int:
        return (self.ram.get(int(key)) + self._staged_count(int(key))
                + self.ds.total_count(int(key)))

    def _staged_count(self, key: int) -> int:
        return 0


class MBTable(FlashHashTableBase):
    """Memory-Bounded buffering (§2.3): flush == merge every dirty block."""

    scheme = "MB"

    def flush(self) -> None:
        groups = self._drain()
        if not groups:
            return
        self.ledger.merge_event()
        for b in sorted(groups):  # ascending block order (semi-random)
            keys, deltas = groups[b]
            self._merge_block(b, keys, deltas)

    def finalize(self) -> None:
        self.flush()


class MDBTable(FlashHashTableBase):
    """Memory+Disk buffering with a *partitioned* change segment (§2.4)."""

    scheme = "MDB"

    def __init__(self, geom: TableGeometry, ram_buffer_pct: float,
                 change_segment_pct: float = 12.5, **kw):
        super().__init__(geom, ram_buffer_pct, **kw)
        self.cs_blocks = max(int(round(change_segment_pct / 100.0
                                       * geom.num_blocks)), 1)
        # each CS block serves k consecutive data blocks
        self.k = -(-geom.num_blocks // self.cs_blocks)  # ceil
        # staged[c] = {key: delta}; pages_used[c] = CS pages consumed
        self.staged: List[Dict[int, int]] = [dict() for _ in range(self.cs_blocks)]
        self.cs_pages_used = np.zeros(self.cs_blocks, dtype=np.int64)

    def _cs_of_block(self, b: int) -> int:
        return min(b // self.k, self.cs_blocks - 1)

    def flush(self) -> None:
        groups = self._drain()
        if not groups:
            return
        self.ledger.stage_event()
        # pack each slot's entries into CS pages (semi-random writes)
        per_cs_entries: Dict[int, int] = {}
        for b, (keys, deltas) in groups.items():
            c = self._cs_of_block(b)
            st = self.staged[c]
            for k_, d_ in zip(keys.tolist(), deltas.tolist()):
                st[k_] = st.get(k_, 0) + d_
            per_cs_entries[c] = per_cs_entries.get(c, 0) + len(keys)
        epp = self.geom.entries_per_page
        for c, n_entries in per_cs_entries.items():
            pages = -(-n_entries // epp)
            self.ledger.write_page_semi(pages)
            self.cs_pages_used[c] += pages
            if self.cs_pages_used[c] >= self.geom.pages_per_block:
                self._merge_cs_block(c)

    def _merge_cs_block(self, c: int) -> None:
        """A CS block filled: merge its staged entries into the k data blocks
        it serves, then erase it (§2.4)."""
        st = self.staged[c]
        self.ledger.merge_event()
        self.ledger.read_block()            # read the CS block
        if st:
            keys = np.fromiter(st.keys(), dtype=np.int64, count=len(st))
            deltas = np.fromiter(st.values(), dtype=np.int64, count=len(st))
            blocks = self.pair.s(keys)
            for b in np.unique(blocks):
                m = blocks == b
                self._merge_block(int(b), keys[m], deltas[m])
        self.staged[c] = {}
        self.cs_pages_used[c] = 0
        self.ledger.erase_block()           # clean the CS block for reuse

    def finalize(self) -> None:
        self.flush()
        for c in range(self.cs_blocks):
            if self.staged[c]:
                self._merge_cs_block(c)

    def _remove_staged(self, key: int) -> None:
        c = self._cs_of_block(int(self.pair.s(key)))
        self.staged[c].pop(key, None)

    def _staged_count(self, key: int) -> int:
        c = self._cs_of_block(int(self.pair.s(key)))
        return self.staged[c].get(key, 0)

    def _query_change_segment(self, key: int) -> int:
        """MDB query: one *block-level* read of the CS block for this slot
        (paper §2.7/§3.4 — dominated by block reads)."""
        c = self._cs_of_block(int(self.pair.s(key)))
        if self.cs_pages_used[c] > 0 or self.staged[c]:
            self.qstats.cs_block_reads += 1
        return self.staged[c].get(key, 0)


class MDBLTable(FlashHashTableBase):
    """MDB-Linear (§2.4): monolithic log-structured change segment."""

    scheme = "MDB-L"

    def __init__(self, geom: TableGeometry, ram_buffer_pct: float,
                 change_segment_pct: float = 12.5, **kw):
        super().__init__(geom, ram_buffer_pct, **kw)
        self.log_capacity_pages = max(
            int(round(change_segment_pct / 100.0 * geom.total_pages)), 1)
        self.log_pages_used = 0
        # staged entries per destination data block + page-pointer ranges
        self.staged: Dict[int, Dict[int, int]] = {}
        self.slot_pages: Dict[int, set] = {}  # slot -> log pages holding it

    def flush(self) -> None:
        groups = self._drain()
        if not groups:
            return
        self.ledger.stage_event()
        epp = self.geom.entries_per_page
        # pack entries of all slots densely into the log, FCFS (§2.4):
        # a log page may contain entries from multiple slots.
        entry_cursor = self.log_pages_used * epp
        for b in sorted(groups):
            keys, deltas = groups[b]
            st = self.staged.setdefault(b, {})
            for k_, d_ in zip(keys.tolist(), deltas.tolist()):
                st[k_] = st.get(k_, 0) + d_
            first_pg = entry_cursor // epp
            entry_cursor += len(keys)
            last_pg = (entry_cursor - 1) // epp if len(keys) else first_pg
            self.slot_pages.setdefault(b, set()).update(
                range(first_pg, last_pg + 1))
        new_pages_used = -(-entry_cursor // epp)
        self.ledger.write_page_seq(new_pages_used - self.log_pages_used)
        self.log_pages_used = new_pages_used
        if self.log_pages_used >= self.log_capacity_pages:
            self._merge_log()

    def _merge_log(self) -> None:
        """Log full: drain everything into the data segment (§2.4). Page
        reads are *repetitive*: every page is read once per data block that
        has entries staged on it (paper §2.4)."""
        self.ledger.merge_event()
        repetitive_reads = sum(len(p) for p in self.slot_pages.values())
        self.ledger.read_page(repetitive_reads)
        for b in sorted(self.staged):
            st = self.staged[b]
            if not st:
                continue
            keys = np.fromiter(st.keys(), dtype=np.int64, count=len(st))
            deltas = np.fromiter(st.values(), dtype=np.int64, count=len(st))
            self._merge_block(b, keys, deltas)
        # erase the log blocks for reuse
        log_blocks = -(-self.log_pages_used // self.geom.pages_per_block)
        self.ledger.erase_block(log_blocks)
        self.staged = {}
        self.slot_pages = {}
        self.log_pages_used = 0

    def finalize(self) -> None:
        self.flush()
        if self.staged:
            self._merge_log()

    def _remove_staged(self, key: int) -> None:
        b = int(self.pair.s(key))
        if b in self.staged:
            self.staged[b].pop(key, None)

    def _staged_count(self, key: int) -> int:
        return self.staged.get(int(self.pair.s(key)), {}).get(key, 0)

    def _query_change_segment(self, key: int) -> int:
        """MDB-L query: pointer-guided *page-level* reads of only the log
        pages holding this slot's entries (§2.7)."""
        b = int(self.pair.s(key))
        pages = self.slot_pages.get(b)
        if pages:
            self.qstats.cs_page_reads += len(pages)
        return self.staged.get(b, {}).get(key, 0)


class NaiveTable(FlashHashTableBase):
    """§3.5 baseline: no buffering — every update is a random page write."""

    scheme = "naive"

    def __init__(self, geom: TableGeometry, **kw):
        super().__init__(geom, ram_buffer_pct=0.0, **kw)
        self.ram.capacity = 1  # flush on every insert

    def flush(self) -> None:
        groups = self._drain()
        for b, (keys, deltas) in groups.items():
            for k, d in zip(keys.tolist(), deltas.tolist()):
                self.ledger.read_page()
                self.ds.apply(int(k), int(d))
                self.ledger.write_page_random()

    def finalize(self) -> None:
        self.flush()


SCHEMES = {"MB": MBTable, "MDB": MDBTable, "MDB-L": MDBLTable,
           "naive": NaiveTable}


def make_table(scheme: str, geom: TableGeometry, ram_buffer_pct: float = 5.0,
               change_segment_pct: float = 12.5, **kw) -> FlashHashTableBase:
    cls = SCHEMES[scheme]
    if scheme in ("MDB", "MDB-L"):
        return cls(geom, ram_buffer_pct, change_segment_pct, **kw)
    if scheme == "naive":
        return cls(geom, **kw)
    return cls(geom, ram_buffer_pct, **kw)
