"""The port's FlashStore, TfIdfPipeline and CorpusStats against the
reference's device store and pipeline on one stream: the same answers,
the same wear ledger, the same write/query counters, the same TF-IDF
scores (computed on the host from identical integers, so exactly equal)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import TableGeometry
from repro.core import table_jax as tj
from repro.core.store import FlashStore as JStore
from repro.core.tfidf import TfIdfPipeline as JPipe
from repro.core.tfidf import tokenize
from repro.data import CorpusStats as JStats
from repro.data import SyntheticCorpus as JCorpus
from repro_torch import convert
from repro_torch.core.store import FlashStore as TStore
from repro_torch.core.tfidf import TfIdfPipeline as TPipe
from repro_torch.data import CorpusStats, SyntheticCorpus

torch.set_num_threads(1)

TABLE = dict(q_log2=10, r_log2=6, log_capacity=256, cs_partitions=4,
             max_updates_per_block=16, overflow_capacity=256)
ENGINE = dict(chunk=64, flush_threshold=96, query_chunk=64, hot_capacity=64)
# wall-clock ledgers: measured, never equal across runs
_TIMED = {"write_overlap_us", "write_stall_us"}
# with a background drain, whether a lookup lands before or after the
# drain's invalidation is a race, so the hot-cache counters may differ
_CACHE_TIMED = {"query_cache_hits", "query_device_queries",
                "query_device_dispatches", "query_invalidations",
                "query_probe_total", "query_probe_max", "query_tile_loads",
                "query_filter_negatives", "query_fenced"}


def _stream(seed=0):
    rng = np.random.default_rng(seed)
    corpus = SyntheticCorpus(num_docs=40, mean_doc_len=60, vocab_size=3000,
                             zipf_a=1.3, seed=seed)
    for i, doc in enumerate(corpus):
        yield "update", doc, None
        if i % 7 == 3:
            keys = rng.integers(0, 3000, 50)
            yield "update", keys, rng.integers(-1, 2, 50)
        if i % 5 == 4:
            yield "query", rng.integers(0, 3500, 80), None
        if i == 25:
            yield "flush", None, None


@pytest.mark.parametrize("async_flush", [False, True])
@pytest.mark.parametrize("scheme", ["MB", "MDB", "MDB-L"])
def test_store_matches_reference_store(scheme, async_flush):
    kw = dict(scheme=scheme, async_flush=async_flush, track_wear=True,
              **TABLE, **ENGINE)
    js = JStore.open(backend="device", **kw)
    ts = TStore.open(backend="device", device="cpu", **kw)
    truth = {}
    for op, a, b in _stream():
        if op == "update":
            js.update(a, b)
            ts.update(a, b)
            for k, d in zip(a.tolist(),
                            [1] * len(a) if b is None else b.tolist()):
                truth[k] = truth.get(k, 0) + d
        elif op == "query":
            want = js.query_batch(a)
            np.testing.assert_array_equal(ts.query_batch(a), want)
            np.testing.assert_array_equal(
                want, [truth.get(k, 0) for k in a.tolist()])
        else:
            js.flush()
            ts.flush()
    js.flush()
    ts.flush()
    keys = np.arange(-1, 3600)
    np.testing.assert_array_equal(ts.query(keys), js.query(keys))
    np.testing.assert_array_equal(ts.partition_heat(keys),
                                  js.partition_heat(keys))
    assert ts.wear() == js.wear()
    assert ts.wear()["dropped"] == 0
    skip = _TIMED | (_CACHE_TIMED if async_flush else set())
    want = {k: v for k, v in js.stats().items() if k not in skip}
    got = {k: v for k, v in ts.stats().items() if k not in skip}
    assert got == want
    got_state = convert.state_to_numpy(ts.state)
    want_state = jax.tree.map(np.asarray, js.state)
    for f in ("keys", "counts", "log_keys", "ov_keys", "filter_words"):
        np.testing.assert_array_equal(got_state[f], getattr(want_state, f))
    js.close()
    ts.close()


DOCS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "macintosh apple computers and the apple fruit",
    "the the the the stopword heavy document",
    "quantum flash storage devices on solid state drives",
]


@pytest.mark.parametrize("scheme", ["MB", "MDB-L"])
def test_tfidf_matches_reference_pipeline(scheme):
    geom = TableGeometry(num_blocks=4, pages_per_block=8, entries_per_page=16)
    ref = JPipe(geom, scheme=scheme, backend="device", q_log2=12, r_log2=8)
    port = TPipe(scheme=scheme, q_log2=12, r_log2=8, device="cpu")
    for d in DOCS:
        ref.add_document(tokenize(d))
        port.add_document(tokenize(d))
    ref.finalize()
    port.finalize()
    vocab = sorted({t for d in DOCS for t in tokenize(d)}) + ["nonexistent"]
    for t in vocab:
        assert port.term_frequency(t) == ref.term_frequency(t)
    np.testing.assert_array_equal(port.idf_many(vocab), ref.idf_many(vocab))
    for d in DOCS:
        doc = tokenize(d)
        assert port.tfidf(doc) == ref.tfidf(doc)
        thr = min(ref.tfidf(doc).values()) * 1.01 + 1e-12
        assert port.keywords(doc, thr) == ref.keywords(doc, thr)
    assert port.term_table.wear() == ref.term_table.wear()
    port.close()


def test_corpus_stats_counts_and_expert_histograms():
    """The port's CorpusStats against the reference's on the same docs:
    counts, expert histograms, IDF weights, document scores, write and
    query counters and wear, exactly; the counts are the docs' own."""
    kw = dict(q_log2=10, r_log2=6, scheme="MDB-L", log_capacity=256)
    ref = JStats.create(**kw)
    st = CorpusStats.create(device="cpu", **kw)
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, 2000, 70) for _ in range(12)]
    flat = np.concatenate(docs)
    uniq, cnt = np.unique(flat, return_counts=True)
    probe = np.concatenate([uniq, rng.integers(2000, 4000, 64)])
    for i, d in enumerate(docs):
        ref.ingest(d)
        st.ingest(d)
        if i % 4 == 3:
            np.testing.assert_array_equal(st.counts(probe),
                                          ref.counts(probe))
    got = st.counts(probe)
    np.testing.assert_array_equal(got, ref.counts(probe))
    np.testing.assert_array_equal(got[:uniq.size], cnt)
    ref.flush()
    st.flush()
    got = st.counts(probe)
    np.testing.assert_array_equal(got, ref.counts(probe))
    np.testing.assert_array_equal(got[:uniq.size], cnt)
    for layer, counts in ((1, [3, 0, 5]), (1, [1, 2, -5]), (2, [7, 7])):
        ref.ingest_expert_counts(layer, np.asarray(counts))
        st.ingest_expert_counts(layer, np.asarray(counts))
    hist = {(layer, n): st.expert_counts(layer, n)
            for layer, n in ((1, 3), (2, 4), (3, 2))}
    for (layer, n), got in hist.items():
        np.testing.assert_array_equal(got, ref.expert_counts(layer, n))
    np.testing.assert_array_equal(hist[1, 3], [4, 2, 0])
    assert (st.docs_seen, st.tokens_seen) == (ref.docs_seen, ref.tokens_seen)
    np.testing.assert_array_equal(st.tfidf_weights(probe),
                                  ref.tfidf_weights(probe))
    for d in docs:
        assert st.doc_score(d) == ref.doc_score(d)
        assert st.doc_filter(0.0)(d) == ref.doc_filter(0.0)(d)
    skip = {k[len("write_"):] for k in _TIMED}
    assert ({k: v for k, v in st.write_stats().items() if k not in skip}
            == {k: v for k, v in ref.write_stats().items() if k not in skip})
    assert st.write_stats()["entries"] == flat.size + 8
    assert st.query_stats() == ref.query_stats()
    assert st.wear() == ref.wear()
    assert st.wear()["dropped"] == 0
    ref.store.close()
    st.store.close()


def test_synthetic_corpus_matches_reference():
    kw = dict(num_docs=6, mean_doc_len=50, vocab_size=1 << 22, zipf_a=1.35,
              seed=3)
    port, want = SyntheticCorpus(**kw), JCorpus(**kw)
    for a, b in zip(port, want):
        np.testing.assert_array_equal(a, b)
    for a, b, _ in zip(port.token_stream(4), want.token_stream(4), range(5)):
        np.testing.assert_array_equal(a, b)


def test_durability_surface_is_not_ported_yet(tmp_path):
    with pytest.raises(NotImplementedError, match="next slice"):
        TStore.open(device="cpu", wal=tmp_path / "wal", **TABLE)
    store = TStore.open(device="cpu", **TABLE)
    with pytest.raises(NotImplementedError):
        store.snapshot(tmp_path)
    with pytest.raises(NotImplementedError):
        store.restore(tmp_path)
    store.close()


def test_reference_table_config_fields_cover_the_port():
    """Store kwargs name table fields by the reference's names."""
    store = TStore.open(device="cpu", **TABLE)
    for k, v in TABLE.items():
        assert (getattr(store.cfg, k) == v
                == getattr(tj.FlashTableConfig(**TABLE), k))
    store.close()
