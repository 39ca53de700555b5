"""Host-side batched query engine for the device flash-hash table.

The paper's query axis (§2.7, Figure 3) measures consolidation cost:
every point query must combine the data segment, the change segment and
the overflow region. Serving that one key at a time pays a full lookup
dispatch — data-segment probe plus whole change-segment scan — per key.
This engine is the batched front door every consumer (TF-IDF, corpus
stats) goes through instead:

* **dedup before dispatch** — duplicate keys in a batch resolve to one
  device probe (``np.unique``), then fan back out to their positions;
* **fixed-shape padded chunks** — misses are EMPTY-padded up to
  ``chunk``, so every dispatch has the same shape whatever the batch;
* **hot-key cache** — a small host dict in front of the device table.
  Counts are global aggregates, so *any* update/merge/flush may move any
  key's count: writers call :meth:`invalidate` (wholesale clear) after
  every mutation rather than tracking per-key dirtiness;
* **invalidate fencing** — drains run on a background worker thread, so
  an invalidation can land while a batch lookup is mid-flight. Every
  ``invalidate()`` bumps an epoch; a lookup only populates the cache if
  the epoch it started under is still current, so a count probed against
  a pre-drain state can never be cached after the drain's invalidation;
* **filter-backed negative verdicts** — when the table carries Bloom
  filters, one cheap ``filter_fn`` dispatch tests the whole miss set
  first: definite misses answer 0 with *no* lookup dispatch at all and
  enter the hot cache as negative entries under the same epoch fence;
* **probe-distance aggregation** — per-key probe distances from the
  device fold into batch-level stats (sum + max); cache hits add nothing.

The engine is state-free with respect to the table: callers pass the
current ``DeviceTableState`` to :meth:`query_batch`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class QueryEngineStats:
    """Batch-aggregated query-path counters."""

    batches: int = 0            # query_batch calls
    keys: int = 0               # keys requested (incl. duplicates)
    unique_keys: int = 0        # after dedup
    cache_hits: int = 0         # unique keys served from the hot cache
    device_queries: int = 0     # unique keys sent to the device
    device_dispatches: int = 0  # lookup launches (chunks)
    invalidations: int = 0      # hot-cache clears by writers
    fenced: int = 0             # cache inserts dropped because a writer
                                # invalidated while the lookup was in flight
    probe_total: int = 0        # sum of device probe distances
    probe_max: int = 0          # worst single probe in any batch
    filter_negatives: int = 0   # unique keys answered 0 by the Bloom
                                # pre-filter with no lookup dispatch
    tile_loads: int = 0         # data-segment tiles read by dispatched
                                # lookups (true negatives contribute 0)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def _to_host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


class BatchedQueryEngine:
    """Dedup + chunk + hot-cache front end over ``table_torch.lookup_ex``."""

    def __init__(self, cfg, chunk: int = 1024, hot_capacity: int = 4096,
                 lookup_fn=None, filter_fn=None):
        from . import table_torch as tt
        self._tt = tt
        self.cfg = cfg
        self.chunk = int(chunk)
        self.hot_capacity = int(hot_capacity)
        # pluggable device dispatch: any (state, keys) -> (counts, dists)
        # or (counts, dists, tile_loads) with lookup_ex's contract
        # (EMPTY -> (0, 0)); the default is the single-table path
        self._lookup = (lookup_fn if lookup_fn is not None
                        else lambda state, q: tt.lookup_ex(self.cfg,
                                                           state, q))
        # optional Bloom pre-filter: (state, keys) -> bool may-contain mask
        # (False ⇒ definitively absent from the whole device table)
        self._filter = filter_fn
        self._hot: Dict[int, int] = {}
        # invalidation epoch: bumped on every invalidate(); lookups fence
        # their cache inserts on it
        self._epoch = 0
        # opt-in happens-before recorder (analysis.race_harness.attach)
        self.tracer = None
        self.stats = QueryEngineStats()

    def _trace(self, kind: str, resource=None, rw=None, **meta) -> None:
        if self.tracer is not None:
            self.tracer.record(kind, resource=resource, rw=rw, **meta)

    # -- cache maintenance --------------------------------------------------
    def invalidate(self) -> None:
        """Writers call this after any update/merge/flush: the whole hot
        cache goes at once, and the epoch fence drops the inserts of a
        lookup racing this call."""
        self._epoch += 1
        self._trace("invalidate", "cache", "w", epoch=self._epoch)
        if self._hot:
            self._hot.clear()
            self.stats.invalidations += 1

    def _remember(self, key: int, count: int) -> None:
        if self.hot_capacity <= 0:
            return  # cache disabled
        if len(self._hot) >= self.hot_capacity and key not in self._hot:
            # FIFO eviction via dict insertion order — cheap, and good
            # enough for a cache that is cleared on every table write
            self._hot.pop(next(iter(self._hot)))
        self._hot[key] = count

    def _padded(self, state, part: np.ndarray) -> torch.Tensor:
        """One fixed-shape chunk on the state's device, EMPTY-padded."""
        pad = self.chunk - part.size
        if pad:
            part = np.concatenate([part, np.full(pad, self._tt.EMPTY,
                                                 np.int64)])
        return torch.as_tensor(part.astype(np.int32), device=state.device)

    # -- the batched read path ---------------------------------------------
    def query_batch(self, state, keys) -> np.ndarray:
        """Counts for ``keys`` (any shape, flattened) against ``state``.

        Returns an int64 array aligned with the flattened input;
        duplicate keys share one probe, ``EMPTY`` keys return 0."""
        tt = self._tt
        flat = np.asarray(keys).reshape(-1).astype(np.int64)
        self.stats.batches += 1
        self.stats.keys += flat.size
        if flat.size == 0:
            return np.zeros(0, np.int64)
        uniq, inv = np.unique(flat, return_inverse=True)
        self.stats.unique_keys += uniq.size
        ucnt = np.zeros(uniq.size, np.int64)
        if not self._hot:
            # cold cache (the steady state under interleaved writes)
            miss_idx = np.flatnonzero(uniq != tt.EMPTY).tolist()
        else:
            self._trace("cache_read", "cache", "r")
            miss_idx = []
            for i, k in enumerate(uniq):
                if k == tt.EMPTY:
                    continue  # padding key: count 0, never probed or cached
                c = self._hot.get(int(k))
                if c is None:
                    miss_idx.append(i)
                else:
                    ucnt[i] = c
                    self.stats.cache_hits += 1
        if miss_idx:
            epoch = self._epoch          # fence: inserts only if unchanged
            self._trace("lookup_begin", "state", "r", epoch=epoch)
            miss = uniq[miss_idx]
            step = self.chunk
            if self._filter is not None and miss.size:
                # Bloom pre-pass: False ⇒ the key is in none of data /
                # change / overflow, so its whole lookup is skipped
                may = np.empty(miss.size, bool)
                for lo in range(0, miss.size, step):
                    part = miss[lo:lo + step]
                    m = _to_host(self._filter(state, self._padded(state,
                                                                  part)))
                    may[lo:lo + part.size] = m[:part.size].astype(bool)
                neg = miss[~may]
                if neg.size:
                    self.stats.filter_negatives += neg.size
                    if epoch == self._epoch:
                        # negative entries are ordinary count-0 entries:
                        # the next invalidate() evicts them wholesale
                        self._trace("cache_insert", "cache", "w",
                                    epoch=epoch)
                        for k in neg:
                            self._remember(int(k), 0)
                    else:
                        self._trace("lookup_fenced", epoch=self._epoch)
                        self.stats.fenced += neg.size
                    keep = np.flatnonzero(may)
                    miss_idx = [miss_idx[i] for i in keep]
                    miss = miss[may]
            self.stats.device_queries += miss.size
            got = np.empty(miss.size, np.int64)
            for lo in range(0, miss.size, step):
                part = miss[lo:lo + step]
                res = self._lookup(state, self._padded(state, part))
                cnt, dist = res[0], res[1]
                if len(res) == 3:
                    self.stats.tile_loads += int(_to_host(res[2]).sum())
                n_real = part.size
                cnt = _to_host(cnt)[:n_real]
                dist = _to_host(dist)[:n_real]
                got[lo:lo + n_real] = cnt
                self.stats.device_dispatches += 1
                self.stats.probe_total += int(dist.sum())
                if dist.size:
                    self.stats.probe_max = max(self.stats.probe_max,
                                               int(dist.max()))
            ucnt[miss_idx] = got
            if epoch == self._epoch:
                self._trace("cache_insert", "cache", "w", epoch=epoch)
                for k, c in zip(miss, got):
                    self._remember(int(k), int(c))
            else:
                # a drain invalidated mid-lookup: these counts may predate
                # it, so they must not outlive the invalidation
                self._trace("lookup_fenced", epoch=self._epoch)
                self.stats.fenced += miss.size
        return ucnt[inv]

    def query(self, state, key: int) -> int:
        """Single-key convenience wrapper (one-element batch)."""
        return int(self.query_batch(state, np.asarray([key]))[0])
