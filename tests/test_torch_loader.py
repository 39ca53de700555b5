"""The port's stateless loader against the reference's: the same numpy
batches bit for bit (tokens, labels, frontend stub embeddings), with and
without a document filter, the flash-hash TF-IDF filter included (the
port's ``CorpusStats`` on the CPU against the reference's, on the same
corpus: the same kept documents, the same batches). Plus the reference's
own loader cases: shapes and ranges, determinism and resume, host
slicing, the filter being consulted."""
import numpy as np
import pytest

from repro.data import CorpusStats as RCorpusStats
from repro.data import LoaderConfig as RLoaderConfig
from repro.data import SyntheticCorpus as RSyntheticCorpus
from repro.data import loader as RL
from repro_torch.data import (CorpusStats, LoaderConfig, SyntheticCorpus,
                              data_state, make_batch)
from repro_torch.data.loader import host_slice


def _pair(filt=None, rfilt=None, **kw):
    base = dict(seq_len=128, global_batch=8, microbatches=2,
                vocab_size=1000)
    base.update(kw)
    corpus = SyntheticCorpus(num_docs=50, mean_doc_len=64, vocab_size=1000,
                             seed=3)
    rcorpus = RSyntheticCorpus(num_docs=50, mean_doc_len=64,
                               vocab_size=1000, seed=3)
    return (LoaderConfig(corpus=corpus, doc_filter=filt, **base),
            RLoaderConfig(corpus=rcorpus, doc_filter=rfilt, **base))


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [{}, {"num_patches": 4, "d_model": 16},
                                {"microbatches": 4, "seq_len": 31}])
def test_batches_match_reference(kw):
    cfg, rcfg = _pair(**kw)
    for step in (0, 1, 7, 1000):
        _same(make_batch(cfg, step), RL.make_batch(rcfg, step))


def test_filtered_batches_match_reference():
    """An arbitrary deterministic filter, consulted on the same documents
    in the same order."""
    seen, rseen = [], []

    def flt(toks):
        seen.append(len(toks))
        return len(toks) % 2 == 0

    def rflt(toks):
        rseen.append(len(toks))
        return len(toks) % 2 == 0

    cfg, rcfg = _pair(flt, rflt)
    for step in (0, 3):
        _same(make_batch(cfg, step), RL.make_batch(rcfg, step))
    assert seen == rseen and len(seen) > 0


def test_tfidf_filtered_batches_match_reference():
    """The flash-hash TF-IDF filter of the train CLI (threshold 0, a
    small table), and the median score as a threshold: the port's
    CorpusStats on the CPU and the reference's score every document the
    same and keep the same ones, so the batches are the same."""
    corpus = SyntheticCorpus(num_docs=64, mean_doc_len=32, vocab_size=509,
                             seed=2)
    rcorpus = RSyntheticCorpus(num_docs=64, mean_doc_len=32, vocab_size=509,
                               seed=2)
    stats = CorpusStats.create(q_log2=12, r_log2=8, device="cpu")
    rstats = RCorpusStats.create(q_log2=12, r_log2=8)
    for d, rd in zip(corpus, rcorpus):
        np.testing.assert_array_equal(d, rd)
        stats.ingest(d)
        rstats.ingest(rd)
    stats.flush()
    rstats.flush()
    assert (stats.tokens_seen, stats.docs_seen) == (rstats.tokens_seen,
                                                    rstats.docs_seen)
    scores = [stats.doc_score(corpus.doc_tokens(i)) for i in range(64)]
    np.testing.assert_allclose(
        scores, [rstats.doc_score(rcorpus.doc_tokens(i)) for i in range(64)],
        rtol=1e-12)
    # the train CLI's threshold (0: every score is ≥ 0) and the median,
    # which drops about half the documents
    for thr in (0.0, float(np.median(scores))):
        keep, rkeep = stats.doc_filter(thr), rstats.doc_filter(thr)
        kept = [keep(corpus.doc_tokens(i)) for i in range(64)]
        assert kept == [rkeep(rcorpus.doc_tokens(i)) for i in range(64)]
        assert 0 < sum(kept) and (thr == 0.0 or sum(kept) < 64)
    kw = dict(seq_len=32, global_batch=4, microbatches=2, vocab_size=509)
    cfg = LoaderConfig(corpus=corpus, doc_filter=keep, **kw)
    rcfg = RLoaderConfig(corpus=rcorpus, doc_filter=rkeep, **kw)
    for step in (0, 5):
        _same(make_batch(cfg, step), RL.make_batch(rcfg, step))
    stats.store.close()


def test_shapes_ranges_and_masking():
    cfg, _ = _pair()
    b = make_batch(cfg, step=0)
    assert b["tokens"].shape == (2, 4, 128)
    assert b["labels"].shape == (2, 4, 128)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 1000
    assert (b["labels"] == -1).sum() > 0   # separators are masked


def test_determinism_resume_and_data_state():
    cfg, _ = _pair()
    b1, b2, b3 = (make_batch(cfg, step=s) for s in (7, 7, 8))
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert data_state(7) == RL.data_state(7) == {"step": 7}


def test_host_slice_matches_reference():
    cfg, _ = _pair()
    b = make_batch(cfg, step=0)
    s0, s1 = host_slice(b, 0, 2), host_slice(b, 1, 2)
    assert s0["tokens"].shape == (2, 2, 128)
    np.testing.assert_array_equal(
        np.concatenate([s0["tokens"], s1["tokens"]], axis=1), b["tokens"])
    _same(s1, RL.host_slice(b, 1, 2))
