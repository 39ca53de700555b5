"""KV prefix-block cache: flash-hash refcounts as the page table of a
paged block pool.

The paper motivates counting hash tables with *reference counting* (§1,
garbage collection). Here that is exactly the serving-side bookkeeping:
prefill KV state is cached per prefix *block* (a fixed number of tokens),
keyed by a rolling hash of the token chain; a **counting** flash-hash
table holds per-block reference counts — +1 while a request uses a block,
−1 on release (deletion-by-decrement, §2.6), and blocks whose count drops
to 0 are evictable.

Physically the values live in a :class:`~.block_pool.BlockPool` — a
fixed slab of slots behind a free-list allocator (pie/vLLM-style paged
KV). The *page table* mapping a token-chain key to its physical slot is
this class plus the refcount store: ``acquire``/``insert``/``release``
are block-granular pin/unpin (±1 through the store's H_R, so a pin/unpin
pair cancels before any device traffic), and eviction takes a
zero-refcount slot. Copy-on-write sharing is structural: block values
are written once and never mutated; a diverging request hashes to new
keys and allocates new slots.

Eviction is **wear-aware** by default (``eviction="wear"``): among
zero-refcount blocks, evict the one whose key lives in the *hottest*
change-segment partition (per-merge ``TableStats`` wear deltas, tracked
by the store's ``track_wear`` feed). A hot partition is being rewritten
anyway, so the eventual re-insertion of that block's refcount dirties a
block that merges regardless; evicting a cold-partition block instead
would later re-dirty a quiet region and buy a fresh block rewrite.
``eviction="first_fit"`` keeps the old drop-the-first-zero-ref policy.

The engine path (``insert(tokens, value, slicer=...)``) stores
*cumulative-prefix* values: key i holds the cache for tokens [0, i·B).
The scheduler's per-block segments (``insert_block``/``acquire_blocks``)
come with the continuous-batching scheduler, which is not ported yet.

The refcounts live in the port's device ``FlashStore`` on ``device`` (the
card unless ``"cpu"`` is asked for, where the flash-hash kernels run as
their plain versions). ``flush_threshold`` (default ``2 *
capacity_blocks``, the reference's) is how many distinct buffered keys
H_R holds before it drains into the device table; a small one sends every
pin and unpin through the flash-hash kernels. The ``sim`` backend and
``snapshot``/``restore`` are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import table_torch as tt
from ..core.store import FlashStore
from .block_pool import BlockPool


def _chain_hash(prev: int, tokens: Sequence[int]) -> int:
    h = np.uint32(prev if prev else 2166136261)
    for t in tokens:
        h = np.uint32(h ^ np.uint32(t & 0xFFFFFFFF))
        h = np.uint32(int(h) * 16777619 & 0xFFFFFFFF)
    out = int(h) & 0x3FFFFFFF
    return out if out else 1


@dataclasses.dataclass
class _Block:
    key: int
    tokens: Tuple[int, ...]
    bid: int                     # physical slot in the BlockPool


class PrefixKVCache:
    def __init__(self, block_tokens: int = 16, capacity_blocks: int = 256,
                 q_log2: int = 12, r_log2: int = 8, scheme: str = "MDB-L",
                 cs_partitions: int = 4, eviction: str = "wear",
                 backend: str = "device", device="cuda",
                 flush_threshold: Optional[int] = None):
        if eviction not in ("wear", "first_fit"):
            raise ValueError(f"unknown eviction policy {eviction!r}")
        if backend == "sim":
            raise NotImplementedError(
                "the sim backend is not ported yet (ROADMAP.md, Queue 1 "
                "item 9)")
        if backend != "device":
            raise ValueError(f"unknown backend {backend!r}")
        self.block_tokens = block_tokens
        self.capacity = capacity_blocks
        self.eviction = eviction
        self.backend = backend
        self.cfg = tt.FlashTableConfig(q_log2=q_log2, r_log2=r_log2,
                                       scheme=scheme,
                                       log_capacity=1 << 10,
                                       cs_partitions=cs_partitions,
                                       max_updates_per_block=1 << 7,
                                       overflow_capacity=1 << 9)
        # batched refcount reads: evictions scan every resident block key
        # in one deduped dispatch, and repeat scans between bumps are
        # served from the store's hot cache + H_R overlay (the store
        # invalidates the cache whenever it flushes to the device).
        # track_wear feeds the per-partition heat the eviction policy uses.
        if flush_threshold is None:
            flush_threshold = 2 * capacity_blocks
        self._refs = FlashStore.open(self.cfg, backend=backend,
                                     device=device, chunk=256,
                                     query_chunk=256,
                                     flush_threshold=flush_threshold,
                                     hot_capacity=4 * capacity_blocks,
                                     track_wear=True)
        self.pool = BlockPool(capacity_blocks)
        self.store: Dict[int, _Block] = {}   # page table: key -> slot
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- hashing -------------------------------------------------------------
    def block_keys(self, tokens: Sequence[int]) -> List[int]:
        """Chain keys for every whole block of the token prefix."""
        keys = []
        prev = 0
        bt = self.block_tokens
        for i in range(0, len(tokens) - len(tokens) % bt, bt):
            prev = _chain_hash(prev, tokens[i:i + bt])
            keys.append(prev)
        return keys

    @property
    def refs(self):
        """Current refcount table state (owned by the store)."""
        return self._refs.state

    def _count(self, keys: List[int]) -> np.ndarray:
        if not keys:
            return np.zeros(0, np.int32)
        # device count + buffered H_R deltas: exact even between flushes
        return self._refs.query_batch(np.asarray(keys, np.int64))

    def _bump(self, keys: List[int], delta: int) -> None:
        if not keys:
            return
        # buffered ±delta: a +1/−1 pair cancels in H_R without device
        # traffic; the store pads/chunks/invalidates when it flushes
        self._refs.update(np.asarray(keys, np.int64),
                          np.full(len(keys), delta, np.int64))

    def _value(self, key: int) -> Any:
        return self.pool.get(self.store[key].bid)

    def _put(self, key: int, tokens: Tuple[int, ...], value: Any) -> None:
        """Page-table insert: evict until a physical slot frees, then map
        ``key`` onto it. The refcount pin (+1) is the caller's."""
        bid = self.pool.alloc(value)
        while bid is None:
            self._evict()
            bid = self.pool.alloc(value)
        self.store[key] = _Block(key, tokens, bid)

    # -- public API: legacy cumulative-prefix path ---------------------------
    def acquire(self, tokens: Sequence[int]) -> Tuple[int, Optional[Any],
                                                      List[int]]:
        """Longest reusable prefix: → (n_cached_tokens, cache_value, keys).
        Bumps refcounts on the blocks the request will pin."""
        keys = self.block_keys(tokens)
        n = 0
        value = None
        for i, k in enumerate(keys):
            if k in self.store:
                n = (i + 1) * self.block_tokens
                value = self._value(k)
            else:
                break
        pinned = keys[:n // self.block_tokens]
        self._bump(pinned, +1)
        if n:
            self.hits += 1
        else:
            self.misses += 1
        return n, value, pinned

    def insert(self, tokens: Sequence[int], value: Any,
               slicer=None) -> List[int]:
        """Register cache state for every whole-block prefix (so future
        requests can reuse *partial* prefixes). ``slicer(value, n_tokens)``
        trims the cache to a block boundary; without one (e.g. SSM states
        are not seq-sliceable) only the full prefix is registered."""
        keys = self.block_keys(tokens)
        if not keys:
            return []
        pinned = []
        items = (list(enumerate(keys)) if slicer is not None
                 else [(len(keys) - 1, keys[-1])])
        for i, k in items:
            if k in self.store:
                continue
            n = (i + 1) * self.block_tokens
            v = slicer(value, n) if slicer is not None else value
            self._put(k, tuple(tokens[:n]), v)
            pinned.append(k)
        self._bump(pinned, +1)
        return pinned

    def release(self, pinned: List[int]) -> None:
        """Decrement refcounts (the paper's deletion-by-decrement)."""
        self._bump(pinned, -1)

    def _evict(self) -> None:
        """Drop a zero-refcount block (full removal, §2.6) and free its
        pool slot.

        ``eviction="wear"``: among the zero-refcount candidates, evict
        the one whose key's change-segment partition has accumulated the
        most merge wear — its eventual re-insertion dirties a partition
        that is being rewritten anyway (ROADMAP wear-aware eviction)."""
        keys = list(self.store.keys())
        counts = self._count(keys)
        zero = [k for k, c in zip(keys, counts) if c <= 0]
        if not zero:
            # all pinned: drop the oldest anyway (degraded mode)
            victim = keys[0]
        else:
            victim = zero[0]
            if self.eviction == "wear" and len(zero) > 1:
                heat = self._refs.partition_heat(np.asarray(zero, np.int64))
                victim = zero[int(np.argmax(heat))]
        self.pool.free(self.store[victim].bid)
        del self.store[victim]
        self.evictions += 1

    def close(self) -> None:
        """Flush the refcount store and join its drain worker."""
        self._refs.close()

    # -- durability: not ported yet ------------------------------------------
    def snapshot(self, path) -> None:
        raise NotImplementedError(
            "snapshot/restore are not ported yet (ROADMAP.md, Queue 1 item 8)")

    def restore(self, path) -> None:
        raise NotImplementedError(
            "snapshot/restore are not ported yet (ROADMAP.md, Queue 1 item 8)")

    def stats(self) -> dict:
        s = self._refs.stats()
        out = {"hits": self.hits, "misses": self.misses,
               "evictions": self.evictions, "resident": len(self.store),
               "scheme": self.cfg.scheme,
               "eviction": self.eviction,
               "backend": self.backend,
               # device backends ledger tile_stores (the paper's cleans
               # analogue); the sim's counterpart is its `cleans` counter
               "tile_stores": s.get("tile_stores", s.get("cleans", 0)),
               "dropped": s.get("dropped", 0),
               "carried": s.get("carried", 0),
               "query_batches": s.get("query_batches",
                                      s.get("queries", 0)),
               "query_cache_hits": s.get("query_cache_hits", 0),
               "query_device_keys": s.get("query_device_queries", 0),
               "write_buffered": s["write_buffered"],
               "write_cancelled": s["write_cancelled"],
               "write_flushes": s["write_flushes"],
               "write_dispatches": s["write_dispatches"]}
        out.update(self.pool.stats())
        return out
