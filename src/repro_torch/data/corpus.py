"""The synthetic corpus of the TF-IDF workload.

``SyntheticCorpus`` is a seeded Zipf document stream matching the paper's
workload statistics knobs (unique/total token ratio — Wiki ≈ 7%, Meme ≈ 4%):
documents are generated on demand from ``(seed, doc_id)`` so any worker can
materialize any document independently (deterministic, resumable,
shardable — no shared state).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    """Zipf-distributed token stream, generated per-document from the seed."""

    num_docs: int = 10_000
    mean_doc_len: int = 400
    vocab_size: int = 1 << 20
    zipf_a: float = 1.3
    seed: int = 0

    def doc_tokens(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ doc_id)
        n = max(int(rng.poisson(self.mean_doc_len)), 8)
        toks = rng.zipf(self.zipf_a, size=n).astype(np.int64)
        return toks % self.vocab_size

    def __iter__(self) -> Iterator[np.ndarray]:
        for d in range(self.num_docs):
            yield self.doc_tokens(d)

    def token_stream(self, start_doc: int = 0) -> Iterator[np.ndarray]:
        d = start_doc
        while True:
            yield self.doc_tokens(d % self.num_docs)
            d += 1
