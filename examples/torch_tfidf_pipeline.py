"""The paper's TF-IDF application end to end, and its role in the LM
stack (flash-hash corpus statistics driving data filtering), in the
PyTorch port: the twin of ``examples/tfidf_pipeline.py``.

Run: PYTHONPATH=src python examples/torch_tfidf_pipeline.py [--device cpu]
(the corpus statistics' table runs on the card by default)
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.core import TableGeometry
from repro_torch.core.tfidf import TfIdfPipeline, tokenize
from repro_torch.data import (CorpusStats, LoaderConfig, SyntheticCorpus,
                              make_batch)

DOCS = [
    "flash devices have fast sequential writes and slow random writes",
    "hash tables rely on the randomness of the hash function",
    "the change segment buffers updates like a log structured file system",
    "counting hash tables keep a frequency per key and support deletion",
    "solid state drives wear out after too many erase write cycles",
] * 20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("=== TF-IDF over the counting hash table (paper §3.2) ===")
    geom = TableGeometry(num_blocks=8, pages_per_block=16,
                         entries_per_page=32)
    pipe = TfIdfPipeline(scheme="MDB-L", backend="sim", geom=geom,
                         ram_buffer_pct=5.0)
    for d in DOCS:
        pipe.add_document(tokenize(d))
    pipe.finalize()
    scores = pipe.tfidf(tokenize(DOCS[0]))
    top = sorted(scores.items(), key=lambda kv: -kv[1])[:5]
    print("top keywords of doc 0:", [t for t, _ in top])
    print(f"'the' idf={pipe.idf('the'):.3f}  'sequential' idf="
          f"{pipe.idf('sequential'):.3f}")
    s = pipe.term_table.stats()
    print(f"I/O ledger: cleans={s['cleans']} block_ops={s['block_ops']} "
          f"page_ops={s['page_ops']}")

    print("\n=== as the LM data layer ===")
    corpus = SyntheticCorpus(num_docs=200, mean_doc_len=96, vocab_size=8000,
                             seed=7)
    stats = CorpusStats.create(q_log2=15, r_log2=9, device=args.device)
    for d in corpus:
        stats.ingest(d)
    stats.flush()
    doc_scores = [stats.doc_score(corpus.doc_tokens(i)) for i in range(20)]
    thr = float(np.median(doc_scores))
    lcfg = LoaderConfig(corpus=corpus, seq_len=128, global_batch=4,
                        microbatches=1, vocab_size=8000,
                        doc_filter=stats.doc_filter(thr))
    batch = make_batch(lcfg, step=0)
    print(f"filtered batch ready: tokens {tuple(batch['tokens'].shape)}, "
          f"median doc score {thr:.3f}")


if __name__ == "__main__":
    main()
