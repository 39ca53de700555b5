"""The port's event-level simulator against the reference's, on the CPU.

Both sides are numpy, so the sim tables must agree on every count and on
every ``CostLedger`` and ``QueryStats`` field bit for bit; the numpy
Bloom mix and the paper's ``HashPair`` must give the reference's uint32
positions and hashes. ``TfIdfPipeline`` with the sim must agree with the
port's device backend (``device="cpu"``) and with the reference's sim:
term frequencies equal, IDF within 1e-9."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import flash_model as ref_fm
from repro.core import hashing as ref_hashing
from repro.core import table_sim as ref_sim
from repro.core.store import FlashStore as RefStore
from repro.core.tfidf import TfIdfPipeline as RefPipe
from repro_torch.core import flash_model, hashing, table_sim
from repro_torch.core.store import FlashStore
from repro_torch.core.tfidf import TfIdfPipeline
from repro_torch.data import SyntheticCorpus

torch.set_num_threads(1)

SIM_SCHEMES = ["MB", "MDB", "MDB-L", "naive"]
_TIMED = {"write_overlap_us", "write_stall_us"}


def _ledger(table) -> dict:
    led = dataclasses.asdict(table.ledger)
    led.update(block_ops=table.ledger.block_ops,
               page_ops=table.ledger.page_ops,
               page_writes=table.ledger.page_writes)
    return led


def _ops(seed=0, n_batches=12, batch=250, keyspace=900):
    """A seeded ±Δ stream with queries and one full removal."""
    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        keys = rng.integers(0, keyspace, batch).astype(np.int64)
        dels = rng.choice(np.array([1, 1, 2, -1], np.int64), batch)
        yield "update", keys, dels
        if i % 3 == 2:
            yield "query", rng.integers(-1, keyspace + 100, 120), None
        if i == 6:
            yield "remove", keys[:5], None
    yield "finalize", None, None
    yield "query", np.arange(-1, keyspace + 100), None


@pytest.mark.parametrize("scheme", SIM_SCHEMES)
def test_sim_table_matches_reference(scheme):
    geom = dict(num_blocks=16, pages_per_block=8, entries_per_page=16)
    kw = dict(ram_buffer_pct=10.0, change_segment_pct=25.0)
    if scheme == "naive":
        kw = {}
    port = table_sim.make_table(scheme, flash_model.TableGeometry(**geom),
                                **kw)
    ref = ref_sim.make_table(scheme, ref_fm.TableGeometry(**geom), **kw)
    for op, a, b in _ops():
        if op == "update":
            port.update_batch(a, b)
            ref.update_batch(a, b)
        elif op == "query":
            np.testing.assert_array_equal(port.query_batch(a),
                                          ref.query_batch(a))
        elif op == "remove":
            assert ([port.remove(int(k)) for k in a]
                    == [ref.remove(int(k)) for k in a])
        else:
            port.finalize()
            ref.finalize()
        assert _ledger(port) == _ledger(ref)
        assert (dataclasses.asdict(port.qstats)
                == dataclasses.asdict(ref.qstats))
    np.testing.assert_array_equal(port.ds.keys, ref.ds.keys)
    np.testing.assert_array_equal(port.ds.counts, ref.ds.counts)
    np.testing.assert_array_equal(port.filters.words, ref.filters.words)
    assert port.ledger.cleans > 0 and port.qstats.filter_negatives > 0
    for dev in ("MLC-1", "MLC-2", "SLC"):
        assert (port.ledger.time_us(flash_model.DEVICES[dev])
                == ref.ledger.time_us(ref_fm.DEVICES[dev]))
        assert (port.qstats.time_us(flash_model.DEVICES[dev])
                == ref.qstats.time_us(ref_fm.DEVICES[dev]))


@pytest.mark.parametrize("bits_log2", [7, 10, 16])
def test_numpy_bloom_positions_match_reference(bits_log2):
    rng = np.random.default_rng(bits_log2)
    x = np.concatenate([rng.integers(-(1 << 40), 1 << 40, 4000),
                        np.arange(-3, 3), [(1 << 31) - 1, 1 << 32]])
    got = hashing.bloom_positions_np(x.astype(np.int64), bits_log2)
    want = ref_hashing.bloom_positions(x.astype(np.int64), bits_log2)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 == w.dtype
        np.testing.assert_array_equal(g, w)
    # the torch mix of the device path gives the same positions
    for g, t in zip(got, hashing.bloom_positions(torch.as_tensor(x),
                                                 bits_log2)):
        np.testing.assert_array_equal(g.astype(np.int64), t.numpy())


def test_hash_pair_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 31, 5000).astype(np.int64)
    for nb, be, a, b in ((16, 1024, None, None), (7, 96, 12345, 678),
                         (1, 1, 3, 0)):
        kw = {} if a is None else dict(a=a, b=b)
        port = hashing.hash_pair_for(nb, be, **kw)
        ref = ref_hashing.hash_pair_for(nb, be, **kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.num_slots == ref.num_slots
        for fn in ("g", "s", "block_of", "home_within_block"):
            np.testing.assert_array_equal(getattr(port, fn)(x),
                                          getattr(ref, fn)(x))
            assert getattr(port, fn)(12345) == getattr(ref, fn)(12345)
    with pytest.raises(ValueError, match="multiple"):
        hashing.HashPair(q=10, r=3)


@pytest.mark.parametrize("scheme", ["MB", "MDB", "MDB-L"])
def test_sim_store_matches_reference_sim_store(scheme):
    """The store layer over the sim (front H_R, threshold drains, the
    write ledger) gives the reference's answers and ``stats()``."""
    kw = dict(scheme=scheme, flush_threshold=150, async_flush=False,
              ram_buffer_pct=10.0, change_segment_pct=25.0)
    geom = dict(num_blocks=16, pages_per_block=8, entries_per_page=16)
    port = FlashStore.open(flash_model.TableGeometry(**geom), backend="sim",
                           **kw)
    ref = RefStore.open(ref_fm.TableGeometry(**geom), backend="sim", **kw)
    for op, a, b in _ops(seed=1):
        if op == "update":
            port.update(a, b)
            ref.update(a, b)
        elif op == "query":
            np.testing.assert_array_equal(port.query(a), ref.query(a))
        elif op == "remove":
            port.drain()
            ref.drain()
        else:
            port.flush()
            ref.flush()
    ps, rs = port.stats(), ref.stats()
    assert ({k: v for k, v in ps.items() if k not in _TIMED}
            == {k: v for k, v in rs.items() if k not in _TIMED})
    assert port.wear() == ref.wear() and ps["cleans"] > 0
    assert port.cfg is None and port.state is None
    port.close()
    ref.close()


def _docs():
    corpus = SyntheticCorpus(num_docs=30, mean_doc_len=80, vocab_size=2500,
                             zipf_a=1.3, seed=4)
    return list(corpus)


@pytest.mark.parametrize("scheme", ["MB", "MDB", "MDB-L"])
def test_tfidf_sim_matches_device_and_reference(scheme):
    geo = dict(num_blocks=16, pages_per_block=16, entries_per_page=16)
    sim_kw = dict(ram_buffer_pct=10.0, change_segment_pct=25.0)
    sim = TfIdfPipeline(scheme=scheme, backend="sim",
                        geom=flash_model.TableGeometry(**geo), **sim_kw)
    ref = RefPipe(ref_fm.TableGeometry(**geo), scheme=scheme, **sim_kw)
    dev = TfIdfPipeline(scheme=scheme, device="cpu", q_log2=12, r_log2=8,
                        log_capacity=1024, cs_partitions=4,
                        max_updates_per_block=64, overflow_capacity=512,
                        chunk=256)
    docs = _docs()
    for d in docs:
        for p in (sim, ref, dev):
            p.add_document_ids(d)
    for p in (sim, ref, dev):
        p.finalize()
    uniq, cnt = np.unique(np.concatenate(docs), return_counts=True)
    keys = np.concatenate([uniq, np.arange(3000, 3100)])
    want = np.concatenate([cnt, np.zeros(100, np.int64)])
    for p in (sim, ref, dev):
        np.testing.assert_array_equal(p.term_table.query_batch(keys), want)
    df = {p: p.doc_table.query_batch(keys) for p in (sim, ref, dev)}
    np.testing.assert_array_equal(df[sim], df[ref])
    np.testing.assert_array_equal(df[sim], df[dev])
    idf = lambda p: np.where(df[p] > 0, np.log(p.num_docs
                                                / np.maximum(df[p], 1)), 0.0)
    np.testing.assert_allclose(idf(sim), idf(ref), rtol=0, atol=1e-9)
    np.testing.assert_allclose(idf(sim), idf(dev), rtol=0, atol=1e-9)
    ps, rs = sim.term_table.stats(), ref.term_table.stats()
    assert ({k: v for k, v in ps.items() if k not in _TIMED}
            == {k: v for k, v in rs.items() if k not in _TIMED})
    assert dev.term_table.wear()["dropped"] == 0
    assert sim.term_table.wear()["cleans"] > 0
    for p in (sim, dev):
        p.close()
    ref.term_table.close()
    ref.doc_table.close()


def test_sim_takes_no_device_and_device_takes_no_geom():
    with pytest.raises(ValueError, match="no device"):
        FlashStore.open(backend="sim", device="cpu")
    with pytest.raises(ValueError, match="geom"):
        TfIdfPipeline(device="cpu", geom=flash_model.TableGeometry(4))
    with pytest.raises(ValueError, match="geom"):
        TfIdfPipeline(backend="sharded", device="cpu",
                      geom=flash_model.TableGeometry(4))
    with pytest.raises(ValueError, match="backend"):
        TfIdfPipeline(backend="replicated", device="cpu")
    pipe = TfIdfPipeline(scheme="naive", backend="sim")
    pipe.add_document(["a", "b", "a"])
    assert pipe.term_frequency("a") == 2
    pipe.close()


def test_core_exports_the_reference_names():
    import repro.core as ref_core
    import repro_torch.core as core
    assert set(ref_core.__all__) <= set(core.__all__)
    assert core.EMPTY == ref_core.EMPTY == -1
    assert set(core.SCHEMES) == set(ref_core.SCHEMES)
    for name in ("MLC1", "MLC2", "SLC"):
        assert (dataclasses.asdict(getattr(core, name))
                == dataclasses.asdict(getattr(ref_core, name)))
