"""Segment layer of the device flash-hash table.

The paper's table is four regions: the *data segment* (closed hash table
in blocks), the *change segment* (a monolithic log for MDB-L or
``cs_partitions`` partitioned buffers for MDB), the *overflow region*,
and the RAM buffer H_R. This module owns the device state record for the
first three and every op the MB / MDB / MDB-L policies share;
:mod:`.table_torch` is scheme policy over these primitives, and
:mod:`.write_engine` is the host-side H_R in front of them.

The reference package's ops are pure functions over donated buffers; here
they update the state's tensors **in place** where the reference donated
them, and return the state record (rebuilt with ``_replace``) so the
call sites read the same. The entry points of :mod:`.table_torch` mark a
consumed state as donated; :func:`assert_live` refuses it.

Functions take the table config duck-typed (``pair``, ``num_blocks``,
``max_updates_per_block`` and, for the partitioned ops,
``cs_partitions`` / ``blocks_per_partition``).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple, Tuple

import torch

from ..kernels.flash_hash import ops as hops
from .hashing import bloom_positions, filter_bits_log2

EMPTY = hops.EMPTY
_I32 = torch.int32


class TableStats(NamedTuple):
    """Wear and traffic counters, each a 0-d int32 tensor on the device."""

    tile_loads: torch.Tensor      # blocks read during merges
    tile_stores: torch.Tensor     # blocks rewritten (the paper's "cleans")
    staged_entries: torch.Tensor  # entries appended to the change segment
    merges: torch.Tensor
    stages: torch.Tensor
    dropped: torch.Tensor         # capacity losses (should be 0)
    carried: torch.Tensor         # updates deferred past a tile's max_u cap


@dataclasses.dataclass(eq=False)
class DeviceTableState:
    """Device state of one table. Field names, shapes and meaning follow
    the reference package's record; ``filter_words`` holds the uint32
    Bloom words as int32 with the same bits."""

    keys: torch.Tensor          # (n_b, r) int32 — data segment
    counts: torch.Tensor        # (n_b, r) int32
    log_keys: torch.Tensor      # (log_cap,) MDB-L / (P, part_cap) MDB
    log_counts: torch.Tensor    # same shape as log_keys
    log_ptr: torch.Tensor       # () int32 MDB-L / (P,) MDB
    ov_keys: torch.Tensor       # (ov_cap,) int32 — overflow region
    ov_counts: torch.Tensor
    ov_ptr: torch.Tensor        # () int32
    filter_words: torch.Tensor  # (n_b, fw) int32 Bloom rows (monotone)
    stats: TableStats
    donated: bool = dataclasses.field(default=False, init=False, repr=False)

    _fields: ClassVar[Tuple[str, ...]] = (
        "keys", "counts", "log_keys", "log_counts", "log_ptr", "ov_keys",
        "ov_counts", "ov_ptr", "filter_words", "stats")

    def _replace(self, **changes) -> "DeviceTableState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.keys.device


def zero_stats(device) -> TableStats:
    z = lambda: torch.zeros((), dtype=_I32, device=device)
    return TableStats(tile_loads=z(), tile_stores=z(), staged_entries=z(),
                      merges=z(), stages=z(), dropped=z(), carried=z())


def init_state(num_blocks: int, block_entries: int, log_shape,
               log_ptr_shape, overflow_capacity: int, filter_words: int,
               device) -> DeviceTableState:
    """Fresh segment state on ``device``: EMPTY data/change/overflow."""
    full = lambda shape, v: torch.full(shape, v, dtype=_I32, device=device)
    return DeviceTableState(
        keys=full((num_blocks, block_entries), EMPTY),
        counts=full((num_blocks, block_entries), 0),
        log_keys=full(log_shape, EMPTY),
        log_counts=full(log_shape, 0),
        log_ptr=full(log_ptr_shape, 0),
        ov_keys=full((overflow_capacity,), EMPTY),
        ov_counts=full((overflow_capacity,), 0),
        ov_ptr=full((), 0),
        filter_words=full((num_blocks, filter_words), 0),
        stats=zero_stats(device),
    )


def assert_live(state: DeviceTableState) -> None:
    """In-place donation guard: ``update``/``flush`` consume their input
    state (its tensors are rewritten in place and its successor is
    returned). A drain that starts from a consumed state means two drains
    raced, or a caller kept a stale reference."""
    if state.donated:
        raise RuntimeError(
            "device table state was already donated: a drain is running "
            "(or ran) on this value — rebind state after every "
            "update/flush and never dispatch two drains on the same state")


# ---------------------------------------------------------------------------
# per-block blocked-Bloom filter
# ---------------------------------------------------------------------------
def filter_or_keys(pair, filt, keys):
    """OR the Bloom bits of ``keys`` into their home blocks' rows, in
    place. Maintenance is monotone (bits are only ever set), so every
    staging and merge path ORs its keys independently. ``EMPTY`` keys
    contribute nothing. Plain PyTorch: the reference computes this
    outside any kernel too (sort + dedup + add of distinct bits)."""
    n_b, fw = filt.shape
    bits_log2 = filter_bits_log2(fw)
    valid = keys != EMPTY
    blk = pair.s(keys[valid]).to(torch.int64)
    if blk.numel() == 0:
        return filt
    base = blk * (fw * 32)
    fids = torch.cat([base + p for p in bloom_positions(keys[valid],
                                                        bits_log2)])
    fids = torch.unique(fids)                      # distinct bits: add == or
    new = torch.zeros(n_b * fw, dtype=torch.int64, device=filt.device)
    new.index_add_(0, fids >> 5, torch.ones_like(fids) << (fids & 31))
    filt |= hops.wrap_i32(new).reshape(n_b, fw)
    return filt


def filter_may_contain(pair, filt, q):
    """Bool ``(Q,)``: False ⇒ ``q`` is in none of the data, change and
    overflow segments (the filter covers all three). ``EMPTY`` is False."""
    bits_log2 = filter_bits_log2(filt.shape[1])
    valid = q != EMPTY
    blk = torch.where(valid, pair.s(q), 0).long()
    may = valid
    for p in bloom_positions(q, bits_log2):
        word = filt[blk, (p >> 5)]
        may = may & (((word >> (p & 31).to(_I32)) & 1) != 0)
    return may


def rebuild_filters(pair, state: DeviceTableState) -> DeviceTableState:
    """Recompute every filter row from the live segments (width
    migrations; the oracle incremental maintenance is tested against)."""
    filt = torch.zeros_like(state.filter_words)
    for keys in (state.keys.reshape(-1), state.log_keys.reshape(-1),
                 state.ov_keys):
        filt = filter_or_keys(pair, filt, keys)
    return state._replace(filter_words=filt)


def accumulate_deltas(tokens, deltas):
    """RAM-buffer dedup with explicit deltas (deletion by -1): unique keys
    in ascending order, EMPTY-padded, with their int32 delta sums."""
    t, order = torch.sort(tokens.to(_I32), stable=True)
    return hops.compact_runs(t, deltas[order])


def compact(keys, counts):
    """Compact valid entries to the front (stable), EMPTY-pad the tail.
    Returns ``(keys, counts, n_valid)`` with ``n_valid`` a 0-d tensor."""
    valid = keys != EMPTY
    idx = torch.nonzero(valid).reshape(-1)
    n = idx.shape[0]
    out_k = torch.full_like(keys, EMPTY)
    out_c = torch.zeros_like(counts)
    out_k[:n] = keys[idx]
    out_c[:n] = counts[idx]
    return out_k, out_c, valid.sum(dtype=_I32)


# ---------------------------------------------------------------------------
# pointer-bumped staging (overflow region + partitioned change segment)
# ---------------------------------------------------------------------------
def scatter_rows(buf_keys, buf_counts, ptrs, rows, keys, cnts):
    """Pointer-bumped append of (keys, cnts) into per-row buffers, in
    place. ``buf_*`` are ``(R, cap)``, ``ptrs`` the ``(R,)`` fill
    pointers; ``rows`` gives each entry's row (``EMPTY`` keys and rows
    outside ``[0, R)`` are padding). Entries pack at their row's pointer
    in stable input order; entries past a row's capacity do not fit and
    come back EMPTY-masked (same ``(U,)`` layout, sorted by row).

    Returns ``(buf_keys, buf_counts, new_ptrs, rest_keys, rest_cnts,
    n_fit)``; ``ptrs`` is updated in place too."""
    R, cap = buf_keys.shape
    (U,) = keys.shape
    dev = keys.device
    valid = (keys != EMPTY) & (rows >= 0) & (rows < R)
    rw = torch.where(valid, rows, R).to(_I32)
    sr, order = torch.sort(rw, stable=True)
    sk, sc = keys[order], cnts[order]
    start = torch.searchsorted(sr, torch.arange(R + 1, dtype=_I32,
                                                device=dev))
    rank = torch.arange(U, device=dev) - start[sr.clamp(0, R).long()]
    pos = ptrs[sr.clamp(0, R - 1).long()] + rank
    fits = (sr < R) & (pos < cap)
    fr, fc = sr[fits].long(), pos[fits]
    buf_keys[fr, fc] = sk[fits]
    buf_counts[fr, fc] = sc[fits]
    n_fit = torch.bincount(fr, minlength=R).to(_I32)
    ptrs += n_fit
    rest = (sr < R) & ~fits
    return (buf_keys, buf_counts, ptrs, torch.where(rest, sk, EMPTY),
            torch.where(rest, sc, 0), n_fit)


def append_overflow(state: DeviceTableState, spill_k, spill_c
                    ) -> DeviceTableState:
    """Compact spilled entries into the overflow region; entries past its
    capacity are genuine losses, counted in ``stats.dropped``."""
    flat_k = spill_k.reshape(-1)
    flat_c = spill_c.reshape(-1)
    _, _, _, rest_k, _, _ = scatter_rows(
        state.ov_keys[None, :], state.ov_counts[None, :],
        state.ov_ptr.reshape(1), torch.zeros_like(flat_k), flat_k, flat_c)
    n_dropped = (rest_k != EMPTY).sum(dtype=_I32)
    return state._replace(stats=state.stats._replace(
        dropped=state.stats.dropped + n_dropped))


def append_log(cfg, state: DeviceTableState, keys, cnts) -> DeviceTableState:
    """Append a deduped chunk behind ``log_ptr`` (sequential write). The
    caller (:func:`table_torch._stage`) guarantees it fits."""
    ptr = int(state.log_ptr)
    n = keys.shape[0]
    state.log_keys[ptr:ptr + n] = keys
    state.log_counts[ptr:ptr + n] = cnts
    n_new = (keys != EMPTY).sum(dtype=_I32)
    stats = state.stats._replace(
        staged_entries=state.stats.staged_entries + n_new,
        stages=state.stats.stages + 1)
    # staged keys are device-visible from here: their filter bits must be
    # set now, so a filter-negative also rules out the change segment
    return state._replace(log_ptr=state.log_ptr + n,
                          filter_words=filter_or_keys(
                              cfg.pair, state.filter_words, keys),
                          stats=stats)


def partition_of(cfg, keys):
    """MDB: partition id per key; invalid keys map to the sentinel P."""
    return torch.where(keys != EMPTY,
                       cfg.pair.s(keys) // cfg.blocks_per_partition,
                       cfg.cs_partitions).to(_I32)


def scatter_partitions(cfg, state: DeviceTableState, keys, cnts):
    """Append a deduped chunk into its partitions. Returns ``(state,
    rest_keys, rest_counts)``: entries whose partition was full are not
    staged and come back EMPTY-masked for a retry after a merge."""
    _, _, _, rest_k, rest_c, n_fit = scatter_rows(
        state.log_keys, state.log_counts, state.log_ptr,
        partition_of(cfg, keys), keys, cnts)
    stats = state.stats._replace(
        staged_entries=state.stats.staged_entries + n_fit.sum(dtype=_I32))
    # conservative: OR in all valid keys, the rest included — they land
    # right after the partition merge, so their bits are a harmless superset
    state = state._replace(filter_words=filter_or_keys(
        cfg.pair, state.filter_words, keys), stats=stats)
    return state, rest_k, rest_c


# ---------------------------------------------------------------------------
# merge paths (all through the merge_dirty kernel)
# ---------------------------------------------------------------------------
def merge_dirty_batch(cfg, state: DeviceTableState, keys, cnts):
    """One dirty-block merge over a flat batch of staged updates.

    The dirty set is the blocks of the staged keys, in ascending id (the
    semi-random write discipline). The reference walks a static grid of
    all ``num_blocks`` with the dirty ones first and no-op visits after;
    here the launch is sized to the dirty count, which gives the same
    state, spills and counters. Updates beyond ``max_updates_per_block``
    per block come back as carry and must stay staged."""
    n_b = cfg.num_blocks
    valid = keys != EMPTY
    blk = torch.where(valid, cfg.pair.s(keys), 0).long()
    per_block = torch.zeros(n_b, dtype=_I32, device=keys.device)
    per_block.index_add_(0, blk, valid.to(_I32))
    dirty = per_block > 0
    ids = torch.nonzero(dirty).reshape(-1).to(_I32)
    n_dirty = ids.shape[0]
    rank = torch.cumsum(dirty, 0, dtype=_I32) - 1
    rows = torch.where(valid, rank[blk], n_dirty).to(_I32)
    uk, uc, carry_k, carry_c, n_carried = hops.bucket_rows(
        rows, keys, cnts, n_dirty, cfg.max_updates_per_block)
    _, _, _, spill_k, spill_c = hops.merge_dirty(
        cfg.pair, state.keys, state.counts, state.filter_words, ids, uk, uc)
    state = append_overflow(state, spill_k, spill_c)
    stats = state.stats._replace(
        tile_loads=state.stats.tile_loads + n_dirty,
        tile_stores=state.stats.tile_stores + n_dirty,
        carried=state.stats.carried + n_carried)
    return state._replace(stats=stats), carry_k, carry_c


def drain_log(cfg, state: DeviceTableState) -> DeviceTableState:
    """Drain the MDB-L log into the data segment (dirty-block merge).
    Carried updates stay staged, compacted to the log head."""
    state, carry_k, carry_c = merge_dirty_batch(
        cfg, state, state.log_keys, state.log_counts)
    log_keys, log_counts, n_carry = compact(carry_k, carry_c)
    stats = state.stats._replace(merges=state.stats.merges + 1)
    return state._replace(log_keys=log_keys, log_counts=log_counts,
                          log_ptr=n_carry, stats=stats)


def merge_partition(cfg, state: DeviceTableState, p: int) -> DeviceTableState:
    """Drain MDB change-segment partition ``p`` into its ``k`` blocks
    ``[p*k, (p+1)*k)``: exactly ``k`` tile loads and stores."""
    k = cfg.blocks_per_partition
    sk = state.log_keys[p]
    sc = state.log_counts[p]
    rows = torch.where(sk != EMPTY, cfg.pair.s(sk) - p * k, k).to(_I32)
    uk, uc, carry_k, carry_c, n_carried = hops.bucket_rows(
        rows, sk, sc, k, cfg.max_updates_per_block)
    dirty = torch.arange(p * k, (p + 1) * k, dtype=_I32, device=sk.device)
    _, _, _, spill_k, spill_c = hops.merge_dirty(
        cfg.pair, state.keys, state.counts, state.filter_words, dirty, uk, uc)
    state = append_overflow(state, spill_k, spill_c)
    # carried updates stay staged at the head of the partition
    new_k, new_c, n_carry = compact(carry_k, carry_c)
    state.log_keys[p] = new_k
    state.log_counts[p] = new_c
    state.log_ptr[p] = n_carry
    stats = state.stats._replace(
        tile_loads=state.stats.tile_loads + k,
        tile_stores=state.stats.tile_stores + k,
        merges=state.stats.merges + 1,
        carried=state.stats.carried + n_carried)
    return state._replace(stats=stats)


# ---------------------------------------------------------------------------
# query-side scan (change segment + overflow, shared across a batch)
# ---------------------------------------------------------------------------
def scan_segment(seg_keys, seg_counts, q):
    """Sum of ``seg_counts`` over the entries of a log/overflow segment
    that match each query (``EMPTY`` never matches). One pass serves the
    whole batch: the segment is sorted once and every query reads its run
    by binary search. int32 sums wrap like the reference's."""
    sk, order = torch.sort(seg_keys)
    csum = torch.zeros(sk.shape[0] + 1, dtype=torch.int64, device=q.device)
    csum[1:] = torch.cumsum(seg_counts[order].to(torch.int64), 0)
    lo = torch.searchsorted(sk, q.to(sk.dtype), right=False)
    hi = torch.searchsorted(sk, q.to(sk.dtype), right=True)
    got = torch.where(q != EMPTY, csum[hi] - csum[lo], 0)
    return hops.wrap_i32(got)
