"""Device-resident counting hash table in PyTorch: scheme policy.

The counterpart of the reference package's ``table_jax``. The HBM table
is the data segment; sort + run-length sums are the RAM buffer; the
append log is the change segment (monolithic for MDB-L, partitioned for
MDB); the ``merge_dirty`` CUDA kernel is the block-level update.
``TableStats`` mirrors the paper's ledger: ``tile_stores`` counts block
rewrites (the clean/wear analogue).

This module is scheme policy only: when each scheme stages, drains and
merges. The state record and the shared ops live in :mod:`.segments`.

* ``MB``    — no change segment; every batch merges at once into the
  blocks it touches.
* ``MDB``   — partitioned change segment; a full partition drains through
  a ``k``-block dirty merge.
* ``MDB-L`` — monolithic log; a full log drains through a dirty merge
  over the blocks with staged keys.

``update`` and ``flush`` consume their input state: tensors are updated
in place and the successor is returned; rebind it
(``state = update(cfg, state, ...)``) and never reuse the argument
(:func:`assert_live` refuses a consumed state). The reference's
``while_loop``/``cond`` loops are Python loops on host scalars here, one
host sync per test.

Every entry point runs on the device the state lives on; :func:`init`
puts it on the card unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.flash_hash import ops as hops
from . import segments as seg
from .hashing import Pow2Hash
from .hashing import filter_words_for as hashing_filter_words_for

EMPTY = seg.EMPTY

TableStats = seg.TableStats
DeviceTableState = seg.DeviceTableState
accumulate_deltas = seg.accumulate_deltas
assert_live = seg.assert_live

_SCHEMES = ("MB", "MDB", "MDB-L")
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class FlashTableConfig:
    """Geometry + policy of a device table (the reference's fields; its
    ``interpret`` flag has no counterpart here)."""

    q_log2: int = 16              # total entries (power of two)
    r_log2: int = 10              # entries per block
    scheme: str = "MDB-L"         # "MB" | "MDB" | "MDB-L"
    log_capacity: int = 1 << 14   # change-segment entries (MDB / MDB-L)
    cs_partitions: int = 8        # MDB: change-segment partitions
    max_updates_per_block: int = 1 << 9   # update-row cap per tile merge
    overflow_capacity: int = 1 << 10
    filters: bool = True          # consult the Bloom filters on lookups
                                  # (maintenance always runs)

    def __post_init__(self):
        if self.scheme not in _SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; "
                             f"expected one of {_SCHEMES}")
        if self.scheme == "MDB":
            if self.cs_partitions <= 0:
                raise ValueError("cs_partitions must be positive")
            if self.num_blocks % self.cs_partitions:
                raise ValueError(
                    f"cs_partitions={self.cs_partitions} must divide "
                    f"num_blocks={self.num_blocks}")
            if self.log_capacity % self.cs_partitions:
                raise ValueError(
                    f"cs_partitions={self.cs_partitions} must divide "
                    f"log_capacity={self.log_capacity}")

    @property
    def pair(self) -> Pow2Hash:
        return Pow2Hash(q_log2=self.q_log2, r_log2=self.r_log2)

    @property
    def num_blocks(self) -> int:
        return 1 << (self.q_log2 - self.r_log2)

    @property
    def block_entries(self) -> int:
        return 1 << self.r_log2

    @property
    def blocks_per_partition(self) -> int:
        """MDB: data blocks covered by one change-segment partition."""
        return self.num_blocks // self.cs_partitions

    @property
    def partition_capacity(self) -> int:
        """MDB: staged entries one change-segment partition can hold."""
        return self.log_capacity // self.cs_partitions

    @property
    def filter_words(self) -> int:
        """32-bit lanes per block's Bloom filter row."""
        return hashing_filter_words_for(self.block_entries)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a usable
    card raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the flash-hash table runs on the "
            "card by default; pass device='cpu' to run the plain versions")
    return dev


def init(cfg: FlashTableConfig, device="cuda") -> DeviceTableState:
    if cfg.scheme == "MDB":
        log_shape = (cfg.cs_partitions, cfg.partition_capacity)
        log_ptr_shape = (cfg.cs_partitions,)
    else:
        log_shape = (cfg.log_capacity,)
        log_ptr_shape = ()
    return seg.init_state(cfg.num_blocks, cfg.block_entries, log_shape,
                          log_ptr_shape, cfg.overflow_capacity,
                          cfg.filter_words, resolve_device(device))


def synchronize(state: DeviceTableState) -> None:
    """Wait until the device really holds ``state`` (a no-op on the CPU):
    synchronises the current stream of the state's device."""
    if state.keys.is_cuda:
        torch.cuda.current_stream(state.keys.device).synchronize()


def _any_valid(keys) -> bool:
    return bool((keys != EMPTY).any())


# ---------------------------------------------------------------------------
# MB policy (§2.3): no change segment
# ---------------------------------------------------------------------------
def _mb_update(cfg: FlashTableConfig, state: DeviceTableState, keys, cnts
               ) -> DeviceTableState:
    """MB: merge the deduped batch at once; carry (a block receiving more
    than ``max_updates_per_block`` updates) merges again until drained."""
    state, carry_k, carry_c = seg.merge_dirty_batch(cfg, state, keys, cnts)
    while _any_valid(carry_k):
        state, carry_k, carry_c = seg.merge_dirty_batch(cfg, state, carry_k,
                                                        carry_c)
    return state._replace(
        stats=state.stats._replace(merges=state.stats.merges + 1))


# ---------------------------------------------------------------------------
# MDB-L policy (§2.4): monolithic log change segment
# ---------------------------------------------------------------------------
def _stage(cfg: FlashTableConfig, state: DeviceTableState, keys, cnts
           ) -> DeviceTableState:
    """Append a deduped chunk to the MDB-L log, merging *repeatedly* until
    the chunk fits behind the carried log head (every merge shrinks the
    per-block carry by ``max_updates_per_block``)."""
    chunk = keys.shape[0]
    cap = cfg.log_capacity
    if chunk > cap:
        raise ValueError("update() must split chunks larger than the log")
    while int(state.log_ptr) + chunk > cap:
        state = seg.drain_log(cfg, state)
    return seg.append_log(cfg, state, keys, cnts)


# ---------------------------------------------------------------------------
# MDB policy (§2.4): partitioned change segment
# ---------------------------------------------------------------------------
def _mdb_merge_where(cfg: FlashTableConfig, state: DeviceTableState, mask
                     ) -> DeviceTableState:
    """Merge every partition whose ``mask`` entry is set."""
    for p in torch.nonzero(mask).reshape(-1).tolist():
        state = seg.merge_partition(cfg, state, p)
    return state


def _partition_load(cfg: FlashTableConfig, keys) -> torch.Tensor:
    """Valid entries per MDB partition (the sentinel partition dropped)."""
    part = seg.partition_of(cfg, keys).long()
    n = torch.zeros(cfg.cs_partitions + 1, dtype=_I32, device=keys.device)
    n.index_add_(0, part, (keys != EMPTY).to(_I32))
    return n[:cfg.cs_partitions]


def _mdb_update(cfg: FlashTableConfig, state: DeviceTableState, keys, cnts
                ) -> DeviceTableState:
    """MDB: stage into per-partition buffers; a partition that cannot fit
    the incoming entries drains first through its k-block dirty merge,
    and draining repeats until everything fits."""
    n_inc = _partition_load(cfg, keys)
    state = _mdb_merge_where(
        cfg, state, state.log_ptr + n_inc > cfg.partition_capacity)
    state, rest_k, rest_c = seg.scatter_partitions(cfg, state, keys, cnts)
    while _any_valid(rest_k):
        state = _mdb_merge_where(cfg, state, _partition_load(cfg, rest_k) > 0)
        state, rest_k, rest_c = seg.scatter_partitions(cfg, state, rest_k,
                                                       rest_c)
    return state._replace(
        stats=state.stats._replace(stages=state.stats.stages + 1))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def _update_impl(cfg: FlashTableConfig, state: DeviceTableState, tokens,
                 deltas: Optional[torch.Tensor] = None) -> DeviceTableState:
    tokens = tokens.to(device=state.device, dtype=_I32)
    if deltas is None:
        keys, cnts = hops.accumulate(tokens)
    else:
        keys, cnts = accumulate_deltas(
            tokens, deltas.to(device=state.device, dtype=_I32))
    if cfg.scheme == "MB":
        return _mb_update(cfg, state, keys, cnts)
    if cfg.scheme == "MDB":
        step = cfg.partition_capacity
        stage_fn = _mdb_update
    else:  # MDB-L
        step = cfg.log_capacity
        stage_fn = _stage
    # chunks larger than the change segment could never fit in one piece
    for i in range(0, max(keys.shape[0], 1), step):
        state = stage_fn(cfg, state, keys[i:i + step], cnts[i:i + step])
    return state


def _consume(old: DeviceTableState, new: DeviceTableState
             ) -> DeviceTableState:
    if new is not old:
        old.donated = True
    return new


def update(cfg: FlashTableConfig, state: DeviceTableState, tokens,
           deltas: Optional[torch.Tensor] = None) -> DeviceTableState:
    """Insert a batch of tokens (or (token, Δ) pairs). ``state`` is
    consumed: its tensors are updated in place; rebind the result."""
    assert_live(state)
    return _consume(state, _update_impl(cfg, state, tokens, deltas))


def flush(cfg: FlashTableConfig, state: DeviceTableState) -> DeviceTableState:
    """Force a merge of any staged state (end-of-stream / checkpoint).
    Consumes ``state`` like :func:`update`."""
    assert_live(state)
    if cfg.scheme == "MB":
        return state
    if cfg.scheme == "MDB":
        return _consume(state, _mdb_merge_where(cfg, state,
                                                state.log_ptr > 0))
    if int(state.log_ptr) > 0:
        return _consume(state, seg.drain_log(cfg, state))
    return state


def lookup_ex(cfg: FlashTableConfig, state: DeviceTableState, q_keys
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched point queries (paper §2.7): data segment (the blocked
    ``query_grid`` probe, one tile read per queried block per wave) plus
    the change-segment and overflow scans, each shared across the batch.
    Returns ``(counts, probe_distances, tile_loads)``; ``EMPTY`` entries
    are padding and answer ``(0, 0)``. With ``cfg.filters`` the Bloom
    pre-pass answers definite misses before any tile read. Read path:
    ``state`` is not consumed."""
    q = q_keys.to(device=state.device, dtype=_I32)
    fw = state.filter_words if cfg.filters else None
    cnt, dist, tiles = hops.query_blocked_ex(
        cfg.pair, state.keys, state.counts, q, 128, fw)
    if cfg.scheme != "MB":  # MB has no change segment to consolidate
        cnt = cnt + seg.scan_segment(state.log_keys.reshape(-1),
                                     state.log_counts.reshape(-1), q)
    cnt = cnt + seg.scan_segment(state.ov_keys, state.ov_counts, q)
    return cnt, dist, tiles


def lookup(cfg: FlashTableConfig, state: DeviceTableState, q_keys
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lookup_ex` without the tile count."""
    cnt, dist, _ = lookup_ex(cfg, state, q_keys)
    return cnt, dist


def filter_probe(cfg: FlashTableConfig, state: DeviceTableState, q_keys
                 ) -> torch.Tensor:
    """Engine-level may-contain verdicts, bool ``(Q,)``: False ⇒ the key
    is absent from the whole table (data + change + overflow segments).
    ``EMPTY`` keys test False."""
    q = q_keys.to(device=state.device, dtype=_I32)
    return seg.filter_may_contain(cfg.pair, state.filter_words, q)


def load_factor(cfg: FlashTableConfig, state: DeviceTableState
                ) -> torch.Tensor:
    return (state.keys != EMPTY).float().mean()
