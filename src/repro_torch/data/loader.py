"""Deterministic, resumable, shardable batch loader (the port's own copy
of the reference's; it yields the same numpy batches bit for bit).

The loader is *stateless*: ``make_batch(cfg, step)`` materializes the
exact global batch for any step from ``(seed, step)`` alone, already in
the pre-microbatched layout the train step consumes. Resume after a
failure is "set step and go": nothing to checkpoint beyond the step
number (recorded in the checkpoint's metadata). On a cluster each host
builds only its slice (``host_slice``).

Documents are packed into fixed-length rows; labels are next-token
targets with cross-document positions masked (-1). Optionally a document
filter (the flash-hash TF-IDF criterion, ``CorpusStats.doc_filter``)
drops low-information documents before packing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from .corpus import SyntheticCorpus


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    corpus: SyntheticCorpus
    seq_len: int
    global_batch: int
    microbatches: int = 1
    vocab_size: int = 50_000        # model vocab; corpus ids are folded in
    num_patches: int = 0            # >0: emit frontend_embeds stub
    d_model: int = 0
    doc_filter: Optional[Callable[[np.ndarray], bool]] = None
    docs_per_row_hint: int = 16


def data_state(step: int) -> Dict[str, int]:
    """What a checkpoint needs to resume the pipeline exactly."""
    return {"step": int(step)}


def _pack_row(cfg: LoaderConfig, rng: np.random.Generator) -> np.ndarray:
    """Pack documents into one row of seq_len+1 tokens (for next-token
    shifting); -1 separators mask the loss across document boundaries."""
    need = cfg.seq_len + 1
    out = np.full(need, -1, dtype=np.int64)
    pos = 0
    doc = rng.integers(0, cfg.corpus.num_docs)
    tries = 0
    while pos < need and tries < 4 * cfg.docs_per_row_hint:
        toks = cfg.corpus.doc_tokens(int(doc))
        tries += 1
        doc = (doc + 1) % cfg.corpus.num_docs
        if cfg.doc_filter is not None and not cfg.doc_filter(toks):
            continue
        take = min(len(toks), need - pos)
        out[pos:pos + take] = toks[:take] % cfg.vocab_size
        pos += take + 1  # leave one -1 separator
    return out


def make_batch(cfg: LoaderConfig, step: int) -> Dict[str, np.ndarray]:
    """Global batch for ``step``: ``tokens`` / ``labels`` (mb, B/mb, S)
    int32 [+ ``frontend_embeds`` (mb, B/mb, P, d) f32]."""
    b, s, mb = cfg.global_batch, cfg.seq_len, cfg.microbatches
    rows = np.empty((b, s + 1), dtype=np.int64)
    for i in range(b):
        rng = np.random.default_rng(
            (cfg.corpus.seed << 40) ^ (step << 16) ^ i)
        rows[i] = _pack_row(cfg, rng)
    tokens = np.maximum(rows[:, :-1], 0).astype(np.int32)
    labels = rows[:, 1:].astype(np.int32)  # -1 positions are masked in loss
    out = {
        "tokens": tokens.reshape(mb, b // mb, s),
        "labels": labels.reshape(mb, b // mb, s),
    }
    if cfg.num_patches:
        rng = np.random.default_rng((cfg.corpus.seed << 40) ^ (step << 16)
                                    ^ 0xFEED)
        out["frontend_embeds"] = rng.standard_normal(
            (mb, b // mb, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def host_slice(batch: Dict[str, np.ndarray], host_id: int,
               num_hosts: int) -> Dict[str, np.ndarray]:
    """Per-host slice of the device-batch dim (axis 1)."""
    def sl(x):
        per = x.shape[1] // num_hosts
        return x[:, host_id * per:(host_id + 1) * per]
    return {k: sl(v) for k, v in batch.items()}
