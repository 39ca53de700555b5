"""Plumbing around the flash-hash kernels (plain PyTorch outside them).

* ``bucket_rows`` — pack staged updates into the dense ``(n_rows, max_u)``
  layout the merge kernel tiles over, given a destination row per
  update. Updates past a row's ``max_u`` capacity are *carried* (returned,
  they stay staged).
* ``bucket_updates`` — ``bucket_rows`` with row = destination block.
* ``accumulate`` — the RAM buffer on the device: sort + run-length sum
  of a token batch into (unique key, count) pairs.
* ``merge`` / ``merge_dirty`` — the merge kernel entry points.
* ``query_sorted`` / ``query_blocked_ex`` / ``query_blocked`` — per-key
  and batched query entry points; the batched one buckets by block so
  each queried tile is read once per wave (``lookup_waves``: the grid
  layouts it launches).

Every function works on the device of its inputs; sorts are stable where
order matters, as in the reference. The wave loops run on host scalars
(one host sync per bucketing pass).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.hashing import Pow2Hash
from . import kernel as _k

EMPTY = _k.EMPTY
_I32 = torch.int32


def bucket_rows(rows, keys, counts, n_rows: int, max_u: int):
    """Pack (keys, counts) updates into ``(n_rows, max_u)`` row buffers.

    ``rows`` is the destination row per update; entries with a row
    outside ``[0, n_rows)`` or ``key == EMPTY`` are padding and dropped.
    Returns ``(upd_keys, upd_counts, carry_keys, carry_counts,
    n_carried)``: ``carry_*`` hold, in sorted-by-row order and
    EMPTY-masked, the updates beyond a row's ``max_u`` capacity."""
    (U,) = keys.shape
    dev = keys.device
    valid = (keys != EMPTY) & (rows >= 0) & (rows < n_rows)
    rw = torch.where(valid, rows, n_rows).to(_I32)
    sr, order = torch.sort(rw, stable=True)
    sk = keys[order]
    sc = counts[order]
    start = torch.searchsorted(sr, torch.arange(n_rows + 1, dtype=_I32,
                                                device=dev))
    pos_in_r = torch.arange(U, device=dev) - start[sr.clamp(0, n_rows).long()]
    keep = (sr < n_rows) & (pos_in_r < max_u)
    upd_keys = torch.full((n_rows, max_u), EMPTY, dtype=keys.dtype, device=dev)
    upd_counts = torch.zeros((n_rows, max_u), dtype=counts.dtype, device=dev)
    kr, kc = sr[keep].long(), pos_in_r[keep]
    upd_keys[kr, kc] = sk[keep]
    upd_counts[kr, kc] = sc[keep]
    carried = (sr < n_rows) & ~keep
    carry_keys = torch.where(carried, sk, EMPTY)
    carry_counts = torch.where(carried, sc, 0)
    return (upd_keys, upd_counts, carry_keys, carry_counts,
            carried.sum(dtype=_I32))


def bucket_updates(pair: Pow2Hash, keys, counts, max_u: int):
    """Pack (keys, counts) into ``(n_b, max_u)`` per-block buffers."""
    n_b = pair.num_slots
    rows = torch.where(keys != EMPTY, pair.s(keys), n_b).to(_I32)
    return bucket_rows(rows, keys, counts, n_b, max_u)


def run_heads(t: torch.Tensor) -> torch.Tensor:
    """Heads of runs of equal values in a sorted vector, EMPTY excluded."""
    is_head = torch.ones_like(t, dtype=torch.bool)
    is_head[1:] = t[1:] != t[:-1]
    return is_head & (t != EMPTY)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wrap)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(_I32)


def compact_runs(t, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted keys ``t`` + per-entry weights -> (unique keys, weight sums),
    compacted to the front in key order and EMPTY-padded; int32 sums wrap
    like the reference's."""
    (T,) = t.shape
    is_head = run_heads(t)
    seg = torch.cumsum(is_head, 0) - 1
    sums = torch.zeros(T, dtype=torch.int64, device=t.device)
    w = torch.where(t != EMPTY, weights.to(torch.int64), 0)
    sums.index_add_(0, seg.clamp(0, T - 1), w)
    heads = torch.nonzero(is_head).reshape(-1)
    keys = torch.full((T,), EMPTY, dtype=_I32, device=t.device)
    cnts = torch.zeros(T, dtype=_I32, device=t.device)
    n = heads.shape[0]
    keys[:n] = t[heads].to(_I32)
    cnts[:n] = wrap_i32(sums[seg[heads]])
    return keys, cnts


def accumulate(tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedup a (T,) int32 token batch into (T,)-shaped unique keys
    (EMPTY-padded, ascending) and int32 counts."""
    t = torch.sort(tokens.to(_I32)).values
    return compact_runs(t, torch.ones_like(t))


def merge(pair: Pow2Hash, table_keys, table_counts, filter_words,
          upd_keys, upd_counts):
    return _k.merge(pair, table_keys, table_counts, filter_words,
                    upd_keys, upd_counts)


def merge_dirty(pair: Pow2Hash, table_keys, table_counts, filter_words,
                dirty_blocks, upd_keys, upd_counts):
    return _k.merge_dirty(pair, table_keys, table_counts, filter_words,
                          dirty_blocks, upd_keys, upd_counts)


def query_sorted(pair: Pow2Hash, table_keys, table_counts, q_keys):
    """Point queries one grid row per key (the per-key reference path):
    sort by block, query, unsort."""
    blk = pair.s(q_keys)
    order = torch.sort(blk, stable=True).indices
    cnts, dists = _k.query(pair, table_keys, table_counts,
                           q_keys[order].to(_I32).contiguous(), 1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return cnts[inv], dists[inv]


def _bucket(pair, q, alive, n_b: int, n_rows: int):
    """Sort the alive queries by block. Returns ``(order, sq, sb, pos,
    max_load, is_first, rank, grid_blocks)``: the sort permutation, keys
    and blocks in sorted order, each key's position within its block's
    group, the fullest block's query count (host int), group heads, each
    key's dense block rank, and the queried blocks in rank order."""
    (Q,) = q.shape
    dev = q.device
    blk = torch.where(alive, pair.s(q), n_b).to(_I32)
    sb, order = torch.sort(blk, stable=True)
    sq = q[order]
    start = torch.searchsorted(sb, torch.arange(n_b + 1, dtype=_I32,
                                                device=dev))
    pos = torch.arange(Q, device=dev) - start[sb.clamp(0, n_b).long()]
    max_load = int((start[1:] - start[:-1]).max())
    is_first = torch.ones(Q, dtype=torch.bool, device=dev)
    is_first[1:] = sb[1:] != sb[:-1]
    is_first &= sb < n_b
    rank = torch.cumsum(is_first, 0) - 1
    grid_blocks = torch.zeros(n_rows, dtype=_I32, device=dev)
    grid_blocks[rank[is_first]] = sb[is_first]
    return order, sq, sb, pos, max_load, is_first, rank, grid_blocks


def _dense_rows(p: int, qcap: int, n_b: int, n_rows: int, sb, pos, rank, sq):
    """Wave ``p``'s ``(n_rows, qcap)`` layout: row = block rank, lane =
    position within the block's group minus ``p * qcap``."""
    lo = p * qcap
    win = (sb < n_b) & (pos >= lo) & (pos < lo + qcap)
    dense = torch.full((n_rows, qcap), EMPTY, dtype=_I32, device=sq.device)
    dense[rank[win], pos[win] - lo] = sq[win]
    g = (rank.clamp(0, n_rows - 1), (pos - lo).clamp(0, qcap - 1))
    return win, dense, g


def _waves(pair, q, alive, n_b: int, n_rows: int, qcap: int):
    """The keys of ``q`` that ``alive`` marks, bucketed by block
    (:func:`_bucket`): ``(order, is_first, waves)``, ``waves`` yielding
    wave ``p``'s ``(win, g, (grid_blocks, dense))`` (:func:`_dense_rows`;
    a grid kernel is launched on ``(grid_blocks, dense)``)."""
    order, sq, sb, pos, max_load, is_first, rank, grid_blocks = _bucket(
        pair, q, alive, n_b, n_rows)
    waves = (_dense_rows(p, qcap, n_b, n_rows, sb, pos, rank, sq)
             for p in range(-(-max_load // qcap)))
    return order, is_first, ((win, g, (grid_blocks, dense))
                             for win, dense, g in waves)


def lookup_waves(pair: Pow2Hash, q, n_b: int, qcap: int, filter_words=None):
    """The grid layouts of :func:`query_blocked_ex` for the int32 batch
    ``q`` (``EMPTY`` is padding) over ``n_b`` blocks.

    With ``filter_words``, the Bloom pre-pass runs
    :func:`kernel.filter_probe_grid` on each wave of the batch, and only
    the keys it passes are bucketed for the query waves. Returns
    ``(probed, order, is_first, waves)``: the ``(grid_blocks, dense)``
    layouts the pre-pass probed (a list; empty without filter words), and
    the queried keys' bucketing as :func:`_waves` gives it."""
    (Q,) = q.shape
    qcap = max(min(qcap, Q), 1)
    n_rows = min(n_b, Q)
    valid = q != EMPTY
    order, is_first, waves = _waves(pair, q, valid, n_b, n_rows, qcap)
    probed = []
    if filter_words is not None:
        may_s = torch.zeros(Q, dtype=_I32, device=q.device)
        for win, g, layout in waves:
            m = _k.filter_probe_grid(filter_words, *layout)
            may_s = torch.where(win, m[g], may_s)
            probed.append(layout)
        may = torch.zeros(Q, dtype=_I32, device=q.device)
        may[order] = may_s
        order, is_first, waves = _waves(pair, q, valid & (may > 0), n_b,
                                        n_rows, qcap)
    return probed, order, is_first, waves


def query_blocked_ex(pair: Pow2Hash, table_keys, table_counts, q_keys,
                     qcap: int = 128, filter_words=None):
    """Batched point queries (paper §2.7).

    Buckets the batch by block into :func:`kernel.query_grid`'s
    ``(n_rows, qcap)`` layout, one row per *queried* block
    (``n_rows = min(n_b, Q)``; surplus rows point at block 0). A wave
    answers up to ``qcap`` queries per block with one tile read; fuller
    blocks drain over more waves.

    With ``filter_words``, a :func:`kernel.filter_probe_grid` pre-pass
    tests every key against its block's Bloom row first and the survivors
    are re-bucketed: blocks whose queries all missed drop out, and the
    wave count follows the post-filter load (possibly zero waves).
    Filtered keys answer ``(0, 0)``.

    ``EMPTY`` entries are padding and return ``(0, 0)``. Returns
    ``(counts, probe_distances, n_tiles)``: the first two aligned with
    ``q_keys``, ``n_tiles`` the number of distinct tiles the query waves
    read (a 0-d int32 tensor)."""
    n_b = table_keys.shape[0]
    (Q,) = q_keys.shape
    dev = table_keys.device
    if Q == 0:
        return (torch.zeros(0, dtype=table_counts.dtype, device=dev),
                torch.zeros(0, dtype=_I32, device=dev),
                torch.zeros((), dtype=_I32, device=dev))
    _, order, is_first, waves = lookup_waves(pair, q_keys.to(_I32), n_b,
                                             qcap, filter_words)
    n_tiles = is_first.sum(dtype=_I32)
    cnt_s = torch.zeros(Q, dtype=table_counts.dtype, device=dev)
    dist_s = torch.zeros(Q, dtype=_I32, device=dev)
    for win, g, layout in waves:
        c, d = _k.query_grid(pair, table_keys, table_counts, *layout)
        cnt_s = torch.where(win, c[g], cnt_s)
        dist_s = torch.where(win, d[g], dist_s)
    cnts = torch.zeros(Q, dtype=table_counts.dtype, device=dev)
    dists = torch.zeros(Q, dtype=_I32, device=dev)
    cnts[order] = cnt_s
    dists[order] = dist_s
    return cnts, dists, n_tiles


def query_blocked(pair: Pow2Hash, table_keys, table_counts, q_keys,
                  qcap: int = 128, filter_words=None):
    """:func:`query_blocked_ex` without the tile count."""
    cnts, dists, _ = query_blocked_ex(pair, table_keys, table_counts,
                                      q_keys, qcap, filter_words)
    return cnts, dists
