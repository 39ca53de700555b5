"""Corpora for the TF-IDF workload.

``SyntheticCorpus`` is a seeded Zipf document stream matching the paper's
workload statistics knobs (unique/total token ratio — Wiki ≈ 7%, Meme ≈ 4%):
documents are generated on demand from ``(seed, doc_id)`` so any worker can
materialize any document independently (deterministic, resumable,
shardable — no shared state). ``read_text_corpus`` reads text files
into token-id documents with the paper's tokenizer.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List

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


def read_text_corpus(path, key_space: int = 1 << 30) -> List[np.ndarray]:
    """Read a directory of .txt files (or one file) into token-id docs, one
    per blank-line-separated paragraph, using the paper's tokenizer (word
    split + FNV-1a ids)."""
    from ..core.tfidf import token_id, tokenize
    p = Path(path)
    files = sorted(p.glob("**/*.txt")) if p.is_dir() else [p]
    docs = []
    for f in files:
        for para in f.read_text(errors="ignore").split("\n\n"):
            toks = tokenize(para)
            if toks:
                docs.append(np.fromiter((token_id(t, key_space)
                                         for t in toks),
                                        dtype=np.int64, count=len(toks)))
    return docs
