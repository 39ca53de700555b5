"""Plain PyTorch versions of the flash-hash kernels and their oracles.

Semantics (per block; the paper's closed-table rules, §2.2/§2.5):

* a block holds ``r`` (power of two) slots; key ``EMPTY=-1`` marks a
  free slot (free slots carry count 0);
* a key's home slot is ``g(x) & (r-1)``; probing walks cyclically
  *within the block only*;
* merging ``(k, Δ)``: the first slot from home that holds ``k`` or
  ``EMPTY`` takes the update; a full block without ``k`` spills it.

Two groups live here:

* the oracles ``merge_block_ref`` / ``merge_ref`` / ``query_ref``, written
  per key and per block, independent of any kernel layout;
* the **plain versions of the kernels**, ``merge_dirty_plain``,
  ``query_grid_plain`` and ``filter_probe_grid_plain``. They repeat the
  kernel bodies step by step (the serial fold over a row's updates, the
  per-lane probe) vectorised across grid rows. The wrappers in
  :mod:`.kernel` run them for CPU tensors; on the card they are what each
  CUDA kernel is held against.
"""
from __future__ import annotations

import torch

from ...core.hashing import Pow2Hash, bloom_positions, filter_bits_log2

EMPTY = -1


def bit_masks(p: torch.Tensor) -> torch.Tensor:
    """int32 single-bit masks ``1 << (p & 31)`` for bit positions ``p``
    (bit 31 is the int32 bit pattern of ``INT32_MIN``)."""
    one = torch.ones(p.shape, dtype=torch.int32, device=p.device)
    return one << (p & 31).to(torch.int32)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------
def merge_block_ref(pair: Pow2Hash, keys, counts, upd_keys, upd_counts):
    """Merge updates into one block, one update at a time. 1-D inputs of
    length ``r`` / ``max_u``. Returns new copies
    ``(keys, counts, spill_keys, spill_counts)``; spills are EMPTY-padded
    to ``max_u``."""
    r = keys.shape[0]
    keys = keys.clone()
    counts = counts.clone()
    spill_k = torch.full_like(upd_keys, EMPTY)
    spill_c = torch.zeros_like(upd_counts)
    n_spill = 0
    kl = keys.tolist()
    for k, c in zip(upd_keys.tolist(), upd_counts.tolist()):
        if k == EMPTY:
            continue
        home = pair.home_within_block(k)
        for d in range(r):
            slot = (home + d) & (r - 1)
            if kl[slot] == k or kl[slot] == EMPTY:
                if kl[slot] == EMPTY:
                    kl[slot] = k
                    keys[slot] = k
                counts[slot] += c
                break
        else:
            spill_k[n_spill] = k
            spill_c[n_spill] = c
            n_spill += 1
    return keys, counts, spill_k, spill_c


def merge_ref(pair: Pow2Hash, table_keys, table_counts, upd_keys, upd_counts):
    """Oracle for the full merge: :func:`merge_block_ref` over every block.
    ``upd_*`` are ``(n_b, max_u)``, bucketed by destination block."""
    outs = [merge_block_ref(pair, table_keys[b], table_counts[b],
                            upd_keys[b], upd_counts[b])
            for b in range(table_keys.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


def query_ref(pair: Pow2Hash, table_keys, table_counts, q_keys):
    """Oracle for point queries against the data segment only.

    Returns ``(counts, probe_distance)`` per query; the distance counts
    slots walked from home, inclusive; an absent key probes to the first
    empty slot. ``EMPTY`` queries are padding and return ``(0, 0)``."""
    r = table_keys.shape[1]
    cnt = torch.zeros(q_keys.shape, dtype=table_counts.dtype)
    dist = torch.zeros(q_keys.shape, dtype=torch.int32)
    for i, k in enumerate(q_keys.tolist()):
        if k == EMPTY:
            continue
        blk = pair.s(k)
        home = pair.home_within_block(k)
        row = table_keys[blk].tolist()
        d_hit = None
        for d in range(r):
            kk = row[(home + d) & (r - 1)]
            if kk == k or kk == EMPTY:
                d_hit = d
                break
        if d_hit is None:
            dist[i] = r
        else:
            slot = (home + d_hit) & (r - 1)
            if row[slot] == k:
                cnt[i] = table_counts[blk, slot]
            dist[i] = d_hit + 1
    return cnt, dist


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------
def merge_dirty_plain(pair: Pow2Hash, table_keys, table_counts, filter_words,
                      dirty_blocks, upd_keys, upd_counts):
    """Plain version of the ``merge_dirty`` kernel (row ``i`` folds
    ``upd_*[i]`` into block ``dirty_blocks[i]``).

    Step ``j`` applies update ``j`` of every row at once, exactly as the
    kernel's serial fold does per row: the target slot is the smallest
    cyclic distance from home holding the key or ``EMPTY``; both Bloom
    bits of every valid key are OR'd in, spills included; spills compact
    in update order. Rows without a valid update write nothing back.
    ``table_keys``, ``table_counts`` and ``filter_words`` are updated in
    place and returned with the ``(n_d, max_u)`` spill arrays."""
    n_d, max_u = upd_keys.shape
    r = table_keys.shape[1]
    rmask = r - 1
    dev = table_keys.device
    bits_log2 = filter_bits_log2(filter_words.shape[1])
    blocks = dirty_blocks.long()
    tk = table_keys[blocks]
    tc = table_counts[blocks]
    tf = filter_words[blocks]
    rows = torch.arange(n_d, device=dev)
    ar = torch.arange(r, dtype=torch.int32, device=dev)
    inf = r + 1
    spill_k = torch.full((n_d, max_u), EMPTY, dtype=upd_keys.dtype, device=dev)
    spill_c = torch.zeros((n_d, max_u), dtype=upd_counts.dtype, device=dev)
    n_spill = torch.zeros(n_d, dtype=torch.int64, device=dev)
    # steps past the last column holding a valid key change nothing
    live = torch.nonzero((upd_keys != EMPTY).any(0))
    n_steps = int(live.max()) + 1 if live.numel() else 0
    for j in range(n_steps):
        k = upd_keys[:, j]
        c = upd_counts[:, j]
        valid = k != EMPTY
        home = pair.home_within_block(k)
        d = (ar[None, :] - home[:, None]) & rmask
        d_match = torch.where(tk == k[:, None], d, inf).amin(1)
        d_empty = torch.where(tk == EMPTY, d, inf).amin(1)
        d_tgt = torch.minimum(d_match, d_empty)
        found = valid & (d_tgt < inf)
        slot = ((home + d_tgt) & rmask).long()
        fr, fs = rows[found], slot[found]
        tc[fr, fs] += c[found]
        ins = found & (d_empty < d_match)
        tk[rows[ins], slot[ins]] = k[ins]
        vr = rows[valid]
        for p in bloom_positions(k[valid], bits_log2):
            w = (p >> 5).long()
            tf[vr, w] = tf[vr, w] | bit_masks(p)
        sp = valid & ~found
        sr, sn = rows[sp], n_spill[sp]
        spill_k[sr, sn] = k[sp]
        spill_c[sr, sn] = c[sp]
        n_spill += sp.long()
    wr = (upd_keys != EMPTY).any(1)
    table_keys[blocks[wr]] = tk[wr]
    table_counts[blocks[wr]] = tc[wr]
    filter_words[blocks[wr]] = tf[wr]
    return table_keys, table_counts, filter_words, spill_k, spill_c


def query_grid_plain(pair: Pow2Hash, table_keys, table_counts, blocks, q2,
                     lane_chunk: int = 0):
    """Plain version of the ``query_grid`` kernel: row ``i`` answers every
    lane of ``q2[i]`` against block ``blocks[i]``'s tile.

    Count = ``counts[slot]`` when the key's cyclic distance is below the
    first ``EMPTY``'s; distance = ``d_match + 1`` on a hit, else
    ``min(d_empty, r-1) + 1``. Lanes are processed ``lane_chunk`` at a
    time (0: a chunk sized to keep each step near 16M elements)."""
    n_rows, qcap = q2.shape
    r = table_keys.shape[1]
    rmask = r - 1
    dev = table_keys.device
    inf = r + 1
    tk = table_keys[blocks.long()]
    tc = table_counts[blocks.long()]
    ar = torch.arange(r, dtype=torch.int32, device=dev)
    cnts = torch.zeros((n_rows, qcap), dtype=table_counts.dtype, device=dev)
    dists = torch.zeros((n_rows, qcap), dtype=torch.int32, device=dev)
    step = lane_chunk or max(1, (1 << 24) // max(n_rows * r, 1))
    for lo in range(0, qcap, step):
        k = q2[:, lo:lo + step]                                   # (n, L)
        home = pair.home_within_block(k)
        d = (ar[None, None, :] - home[..., None]) & rmask         # (n, L, r)
        d_match = torch.where(tk[:, None, :] == k[..., None], d, inf).amin(2)
        d_empty = torch.where(tk[:, None, :] == EMPTY, d, inf).amin(2)
        found = d_match < d_empty
        slot = ((home + d_match) & rmask).long()
        got = torch.gather(tc, 1, slot)
        cnts[:, lo:lo + step] = torch.where(found, got, 0)
        dists[:, lo:lo + step] = torch.where(
            found, d_match, torch.clamp(d_empty, max=r - 1)) + 1
    return cnts, dists


def filter_probe_grid_plain(filter_words, blocks, q2):
    """Plain version of the ``filter_probe_grid`` kernel: lane ``(i, j)``
    tests ``q2[i, j]`` against block ``blocks[i]``'s Bloom row (AND of the
    two bit tests); ``EMPTY`` gives 0. Returns an int32 mask."""
    bits_log2 = filter_bits_log2(filter_words.shape[1])
    rows = filter_words[blocks.long()]                            # (n, fw)
    hit = q2 != EMPTY
    for p in bloom_positions(q2, bits_log2):
        word = torch.gather(rows, 1, (p >> 5).long())
        hit &= ((word >> (p & 31).to(torch.int32)) & 1) != 0
    return hit.to(torch.int32)
