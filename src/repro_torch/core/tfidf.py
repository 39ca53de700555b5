"""TF-IDF on counting hash tables — the paper's driving application (§1, §3.2).

Two counting tables are maintained while streaming a corpus:

* ``term_table``  — global term frequencies (every token occurrence),
* ``doc_table``   — document frequencies (each unique token once per doc).

``tfidf(w, d) = tf(w, d) * log(N / df(w))`` (Salton–Buckley weighting [32]).

Each table is a :class:`~.store.FlashStore` on the device backend, with
any of the MB / MDB / MDB-L schemes; it lives on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .store import FlashStore


def tokenize(text: str) -> List[str]:
    return [t for t in
            "".join(c.lower() if c.isalnum() else " " for c in text).split()
            if t]


def token_id(token: str, key_space: int = 1 << 30) -> int:
    """Stable 31-bit token id (FNV-1a); the hash-table key domain."""
    h = 2166136261
    for ch in token.encode("utf-8"):
        h ^= ch
        h = (h * 16777619) & 0xFFFFFFFF
    return h % key_space


class TfIdfPipeline:
    """Streaming TF-IDF scorer over two device counting tables.

    ``store_kw`` passes table fields (``log_capacity``,
    ``max_updates_per_block``, ...) and engine knobs (``chunk``,
    ``async_flush``, ...) through to :meth:`FlashStore.open`."""

    def __init__(self, scheme: str = "MDB-L", track_df: bool = True,
                 backend: str = "device", q_log2: int = 14, r_log2: int = 9,
                 device="cuda", **store_kw):
        if backend != "device":
            raise ValueError(f"unknown backend {backend!r}; this package "
                             "has the device backend only")
        if scheme == "naive":
            raise ValueError("the device table has no naive scheme")
        mk = lambda: FlashStore.open(backend=backend, scheme=scheme,
                                     q_log2=q_log2, r_log2=r_log2,
                                     device=device, **store_kw)
        self.backend = backend
        self.term_table = mk()
        self.doc_table = mk() if track_df else None
        self.num_docs = 0
        self.total_tokens = 0

    # -- ingestion ---------------------------------------------------------
    def add_document(self, tokens: Sequence[str]) -> None:
        ids = np.fromiter((token_id(t) for t in tokens), dtype=np.int64,
                          count=len(tokens))
        self.add_document_ids(ids)

    def add_document_ids(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            self.num_docs += 1
            return
        self.term_table.update(ids)
        if self.doc_table is not None:
            self.doc_table.update(np.unique(ids))
        self.num_docs += 1
        self.total_tokens += len(ids)

    # -- queries -------------------------------------------------------------
    def term_frequency(self, token: str) -> int:
        """A paper-workload query: 'how frequent is this keyword' (§3.3)."""
        return self.term_table.query(token_id(token))

    def _df_many(self, tokens: Sequence[str]) -> np.ndarray:
        """Document frequencies for a token list, one batched lookup."""
        if self.doc_table is None:
            raise ValueError("df tracking disabled")
        ids = np.fromiter((token_id(t) for t in tokens), dtype=np.int64,
                          count=len(tokens))
        return np.asarray(self.doc_table.query_batch(ids), dtype=np.int64)

    def idf(self, token: str) -> float:
        return float(self.idf_many([token])[0])

    def idf_many(self, tokens: Sequence[str]) -> np.ndarray:
        """Vectorized IDF: all tokens resolved in one batched df lookup."""
        df = self._df_many(tokens)
        out = np.zeros(len(tokens), np.float64)
        pos = df > 0
        out[pos] = np.log(self.num_docs / df[pos])
        return out

    def tfidf(self, doc_tokens: Sequence[str]) -> Dict[str, float]:
        """Score one document against the accumulated corpus statistics;
        its unique terms resolve in a single batched df lookup."""
        if not doc_tokens:
            return {}
        tf: Dict[str, int] = {}
        for t in doc_tokens:
            tf[t] = tf.get(t, 0) + 1
        idf = self.idf_many(list(tf))   # insertion order = unique terms
        n = len(doc_tokens)
        return {t: (c / n) * idf[i] for i, (t, c) in enumerate(tf.items())}

    def keywords(self, doc_tokens: Sequence[str], threshold: float) -> List[str]:
        """Paper §1: keywords = words with TF-IDF above a threshold."""
        scores = self.tfidf(doc_tokens)
        return sorted((t for t, v in scores.items() if v >= threshold),
                      key=lambda t: -scores[t])

    def finalize(self) -> None:
        self.term_table.flush()
        if self.doc_table is not None:
            self.doc_table.flush()

    def close(self) -> None:
        """Flush and release both tables (their drain workers join)."""
        self.term_table.close()
        if self.doc_table is not None:
            self.doc_table.close()
