"""Corpus statistics service: the paper's counting hash table as a
streaming statistics engine.

``CorpusStats`` ingests token batches into a device flash-hash table
(MDB-L by default — the paper's recommendation) through the port's
:class:`~repro_torch.core.store.FlashStore`, which owns the H_R
buffering, the threshold flushes and the flush → invalidate contract, so
reads between ingests are never stale. On top of it:

* ``tfidf_weights`` — per-token IDF weights for corpus filtering,
* ``doc_filter`` — the paper's TF-IDF keyword criterion as a document
  filter,
* ``expert_stats`` — counting-table accumulation of expert-load
  histograms (counting semantics across steps).

Snapshots are not in this package yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core import table_torch as tt
from ..core.store import FlashStore


class CorpusStats:
    def __init__(self, cfg: tt.FlashTableConfig,
                 state: Optional[tt.DeviceTableState] = None,
                 docs_seen: int = 0, tokens_seen: int = 0,
                 backend: str = "device", device="cuda"):
        self.cfg = cfg
        self.docs_seen = docs_seen
        self.tokens_seen = tokens_seen
        self.store = FlashStore.open(cfg, backend=backend, state=state,
                                     device=device)

    @classmethod
    def create(cls, q_log2: int = 18, r_log2: int = 10,
               scheme: str = "MDB-L", backend: str = "device",
               device="cuda", **table_kw) -> "CorpusStats":
        """Any device scheme (MB / MDB / MDB-L) backs the stats engine;
        ``table_kw`` forwards change-segment knobs (``log_capacity``,
        ``cs_partitions``, ...) to :class:`tt.FlashTableConfig`."""
        cfg = tt.FlashTableConfig(q_log2=q_log2, r_log2=r_log2,
                                  scheme=scheme, **table_kw)
        return cls(cfg=cfg, backend=backend, device=device)

    @property
    def state(self) -> tt.DeviceTableState:
        """Current device table state (owned by the store)."""
        return self.store.state

    def wear(self) -> Dict[str, int]:
        """Device wear/traffic counters (``tile_stores`` = paper cleans),
        including ``dropped``/``carried``."""
        return self.store.wear()

    def query_stats(self) -> Dict[str, int]:
        """Batch-aggregated read-path counters."""
        return {k[len("query_"):]: v for k, v in self.store.stats().items()
                if k.startswith("query_")}

    def write_stats(self) -> Dict[str, int]:
        """H_R write-path counters."""
        return {k[len("write_"):]: v for k, v in self.store.stats().items()
                if k.startswith("write_")}

    # -- ingestion ----------------------------------------------------------
    def ingest(self, tokens: np.ndarray) -> None:
        """Add one batch/document of token ids (host array): buffered in
        H_R, dispatched to the device at the flush threshold."""
        t = np.asarray(tokens).reshape(-1)
        self.store.update(t)
        self.docs_seen += 1
        self.tokens_seen += int(t.size)

    def flush(self) -> None:
        """Drain H_R and force the device merge."""
        self.store.flush()

    # -- queries ------------------------------------------------------------
    def counts(self, tokens: np.ndarray) -> np.ndarray:
        """Batched frequency lookup with the buffered H_R deltas overlaid."""
        q = np.asarray(tokens).reshape(-1)
        return self.store.query_batch(q)

    def tfidf_weights(self, tokens: np.ndarray) -> np.ndarray:
        """IDF-style weights: log(total / freq) per queried token."""
        c = np.maximum(self.counts(tokens), 1)
        return np.log(max(self.tokens_seen, 1) / c)

    def doc_score(self, doc_tokens: np.ndarray) -> float:
        """Mean TF-IDF of the document against corpus stats."""
        toks, tf = np.unique(np.asarray(doc_tokens), return_counts=True)
        idf = self.tfidf_weights(toks)
        return float((tf / max(len(doc_tokens), 1) * idf).sum())

    def doc_filter(self, threshold: float):
        """Loader-pluggable filter: keep docs above the TF-IDF score."""
        def keep(doc_tokens: np.ndarray) -> bool:
            return self.doc_score(doc_tokens) >= threshold
        return keep

    # -- expert-load accounting ---------------------------------------------
    def ingest_expert_counts(self, layer: int, counts: np.ndarray) -> None:
        """Accumulate per-expert token counts into the same table (keys are
        (layer, expert) pairs — counting semantics, deletion-capable)."""
        e = counts.shape[0]
        keys = (np.arange(e, dtype=np.int64) | (np.int64(layer) << 16))
        self.store.update(keys, np.asarray(counts, np.int64))

    def expert_counts(self, layer: int, num_experts: int) -> np.ndarray:
        keys = (np.arange(num_experts, dtype=np.int64)
                | (np.int64(layer) << 16))
        return self.counts(keys)
