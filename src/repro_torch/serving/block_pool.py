"""Paged KV block pool: fixed-size token blocks behind a free-list.

The serving layer stores prefill KV state in fixed-size *blocks* of
``NUM_TOKENS_IN_BLOCK`` tokens (pie/vLLM-style paged KV). This module owns
the physical side only: a fixed slab of slots, a free-list allocator, and
occupancy accounting. The *logical* side — which token chain lives in
which slot, who holds it pinned, which zero-ref slot to evict — is the
:class:`~.prefix_cache.PrefixKVCache`, whose counting
flash-hash refcounts ARE the page table.

Copy-on-write sharing falls out of content hashing: a block slot is
keyed by the rolling hash of its token chain, so two requests sharing a
prefix pin the *same* slots, and a request that diverges hashes to fresh
keys and allocates fresh slots — shared block values are never mutated.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

#: default tokens per KV block (the pie backend's NUM_TOKENS_IN_BLOCK)
NUM_TOKENS_IN_BLOCK = 16


class BlockPool:
    """Fixed-capacity slab of KV block slots with a free-list allocator.

    Values are opaque (lists of cache tensors in the engine; anything in
    tests). The pool never copies or mutates a
    stored value — copy-on-write is enforced structurally: a slot's value
    is written once at :meth:`alloc` and only dropped at :meth:`free`.
    """

    def __init__(self, capacity_blocks: int):
        if capacity_blocks <= 0:
            raise ValueError(f"capacity_blocks must be > 0, got "
                             f"{capacity_blocks}")
        self.capacity = int(capacity_blocks)
        self._slots: List[Any] = [None] * self.capacity
        # LIFO free-list: recently-freed slots are re-used first (their
        # refcount keys are the ones whose H_R ±1 pairs still cancel)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self.allocs = 0
        self.frees = 0
        self.high_water = 0

    # -- allocator ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, value: Any) -> Optional[int]:
        """Take a free slot, store ``value``, return its block id — or
        None when the pool is exhausted (the caller evicts and retries)."""
        if not self._free:
            return None
        bid = self._free.pop()
        self._slots[bid] = value
        self.allocs += 1
        self.high_water = max(self.high_water, self.in_use)
        return bid

    def get(self, bid: int) -> Any:
        """Read a slot's value (shared, never copied — CoW discipline)."""
        return self._slots[bid]

    def free(self, bid: int) -> None:
        """Return a slot to the free list and drop its value."""
        if self._slots[bid] is None and bid in self._free:
            raise ValueError(f"double free of block {bid}")
        self._slots[bid] = None
        self._free.append(bid)
        self.frees += 1

    def stats(self) -> Dict[str, int]:
        return {"pool_capacity": self.capacity, "pool_in_use": self.in_use,
                "pool_free": self.num_free, "pool_allocs": self.allocs,
                "pool_frees": self.frees,
                "pool_high_water": self.high_water}
