"""The port's sharded store (``FlashStore(backend="sharded")``,
``core/distributed.py``) against the reference's, in one process.

* the owner bucketing, the owner map and the global pair, called
  in-process on both packages (the reference's are plain jnp);
* the reference's sharded store on 8 virtual CPU devices
  (``tests/helpers/torch_sharded_ref_main.py``, run once per module)
  and the port's 8-shard store on the CPU on one ±Δ stream, for MB, MDB
  and MDB-L: every integer leaf of the global state bit for bit, the
  same answers mid-stream and after the flush, the same ``write_*``
  ledger and ``tile_loads``, nothing carried or dropped;
* sharded snapshots restored across the packages, both ways;
* the facade against the sim, shard-local thresholds, one shard against
  the device backend, TF-IDF and corpus statistics against the device
  backend, and the per-part WAL."""
import importlib.util
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.core import table_jax as tj
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core import distributed as D
from repro_torch.core import table_torch as tt
from repro_torch.core.store import FlashStore
from repro_torch.core.tfidf import TfIdfPipeline
from repro_torch.core.wal import COMMIT, SEAL, read_wal
from repro_torch.data import CorpusStats

torch.set_num_threads(1)
HELPERS = Path(__file__).resolve().parent / "helpers"
REF_HELPER = HELPERS / "torch_sharded_ref_main.py"
_spec = importlib.util.spec_from_file_location(
    "torch_multihost_main", HELPERS / "torch_multihost_main.py")
mh = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mh)

SCHEMES = ["MB", "MDB", "MDB-L"]
# wall-clock ledgers: measured, never equal across runs
_TIMED = {"write_overlap_us", "write_stall_us"}


def _run_ref(*args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, str(REF_HELPER), *map(str, args)],
                         capture_output=True, text=True, timeout=900, env=env)
    assert "REF_SHARDED_OK" in out.stdout, out.stdout[-3000:] + \
        out.stderr[-3000:]


@pytest.fixture(scope="module")
def ref_dump(tmp_path_factory):
    """The reference's sharded store after the parity stream, per scheme:
    its global state, answers, stats and snapshot."""
    out = tmp_path_factory.mktemp("ref_sharded")
    _run_ref("dump", out)
    return out


def _cfg(scheme, n=mh.NUM_SHARDS):
    return D.ShardedTableConfig(
        local=tt.FlashTableConfig(**mh.table_kwargs(scheme)),
        num_shards=n, bucket_cap=mh.BUCKET_CAP)


def _open(scheme, **kw):
    return FlashStore.open(_cfg(scheme), backend="sharded", device="cpu",
                           **{**mh.PARITY, **kw})


def _state(store):
    return flatten(D.global_arrays(store.state))


def _assert_same_state(got: dict, want) -> None:
    names = sorted(k for k in want if not k.startswith("answers"))
    assert sorted(got) == names
    for k in names:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# routing: the owner buckets, the owner map, the placement property
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap,n", [(64, 8), (7, 8), (3, 4)])
def test_bucket_by_owner_matches_the_reference(cap, n):
    """Fixed (n, cap) buckets in stable owner order, EMPTY owned by n;
    what overflows a bucket comes back as carry (cap 7 and 3 overflow)."""
    local = dict(q_log2=8, r_log2=5)
    rcfg = RD.ShardedTableConfig(local=tj.FlashTableConfig(**local),
                                 num_shards=n, bucket_cap=cap)
    pcfg = D.ShardedTableConfig(local=tt.FlashTableConfig(**local),
                                num_shards=n, bucket_cap=cap)
    rng = np.random.default_rng(cap)
    keys = rng.integers(0, 1 << 20, 200).astype(np.int32)
    keys[rng.random(200) < 0.2] = -1
    cnts = rng.integers(-3, 9, 200).astype(np.int32)
    want = RD._bucket_by_owner(rcfg, jnp.asarray(keys), jnp.asarray(cnts))
    got = D._bucket_by_owner(pcfg, torch.as_tensor(keys),
                             torch.as_tensor(cnts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    carried = int((got[2] != -1).sum())
    assert (carried > 0) == (cap < 64)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_owner_map_and_global_pair_match_the_reference(n):
    local = dict(q_log2=10, r_log2=7)
    rcfg = RD.ShardedTableConfig(local=tj.FlashTableConfig(**local),
                                 num_shards=n)
    pcfg = D.ShardedTableConfig(local=tt.FlashTableConfig(**local),
                                num_shards=n)
    rp, pp = rcfg.global_pair, pcfg.global_pair
    assert (rp.q_log2, rp.r_log2, rp.mult) == (pp.q_log2, pp.r_log2, pp.mult)
    assert rcfg.global_blocks == pcfg.global_blocks
    keys = np.random.default_rng(n).integers(0, 1 << 30, 4096)
    # the reference's ShardedBackend.owner_of, whose mesh needs n devices
    want = np.asarray(rp.s(keys)) >> (local["q_log2"] - local["r_log2"])
    st = FlashStore.open(pcfg, backend="sharded", device="cpu")
    np.testing.assert_array_equal(st._b.owner_of(keys), want)
    assert set(want.tolist()) == set(range(n))
    st.close()


def test_local_placement_agrees_with_the_owner_routing():
    """With a shared multiplier the local block is the global block masked
    to the shard's blocks, and the home within the block is the same."""
    cfg = D.ShardedTableConfig(local=tt.FlashTableConfig(q_log2=12, r_log2=6),
                               num_shards=8)
    x = torch.as_tensor(np.random.default_rng(1).integers(0, 1 << 31, 10000))
    gp, lp = cfg.global_pair, cfg.local.pair
    nb = cfg.local.num_blocks
    assert torch.equal(lp.s(x), gp.s(x) & (nb - 1))
    assert torch.equal(lp.home_within_block(x), gp.home_within_block(x))
    assert torch.equal(D.owner_of(cfg, x), gp.s(x) // nb)


# ---------------------------------------------------------------------------
# the store against the reference's, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_store_matches_the_reference(scheme, ref_dump):
    want = np.load(ref_dump / f"{scheme}.npz")
    want_stats = json.loads((ref_dump / f"{scheme}.json").read_text())
    st = _open(scheme)
    mid, final = mh.parity_run(st)
    np.testing.assert_array_equal(mid, want["answers/mid"])
    np.testing.assert_array_equal(final, want["answers/final"])
    np.testing.assert_array_equal(final,
                                  mh.truth_of(mh.make_batches(deltas=True)))
    _assert_same_state(_state(st), want)
    s = st.stats()
    ledger = {k for k in want_stats
              if k.startswith("write_") and k not in _TIMED}
    assert {k: s[k] for k in ledger} == {k: want_stats[k] for k in ledger}
    assert s["query_tile_loads"] == want_stats["query_tile_loads"]
    assert s["write_carried"] == 0 and s["dropped"] == 0
    assert s["write_auto_flushes"] > 0 and s["write_piggybacked"] > 0
    assert s["shards"] == 8 and s["collectives"] == "local"
    assert s["placement"] == "8 shards on cpu"
    st.close()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_reference_sharded_snapshot_restores_in_the_port(scheme, ref_dump):
    want = np.load(ref_dump / f"{scheme}.npz")
    st = _open(scheme)
    rep = st.restore(ref_dump / f"snap_{scheme}")
    assert rep.snapshot_step == 0 and rep.records_replayed == 0
    _assert_same_state(_state(st), want)
    np.testing.assert_array_equal(
        st.query(np.arange(mh.UNIVERSE)), want["answers/final"])
    st.close()


def test_port_sharded_snapshot_restores_in_the_reference(tmp_path):
    answers = {}
    for scheme in SCHEMES:
        st = _open(scheme)
        answers[scheme] = mh.parity_run(st)[1]
        states = _state(st)
        st.snapshot(tmp_path / "snap" / scheme)
        st.close()
        np.savez(tmp_path / f"port_{scheme}.npz", **states)
    _run_ref("restore", tmp_path / "snap", tmp_path / "out")
    for scheme in SCHEMES:
        got = np.load(tmp_path / "out" / f"restored_{scheme}.npz")
        np.testing.assert_array_equal(got["answers"], answers[scheme])
        mine = np.load(tmp_path / f"port_{scheme}.npz")
        _assert_same_state({k: got[k] for k in got.files if k != "answers"},
                           mine)


def test_global_arrays_round_trip_and_refuse_another_geometry():
    st = _open("MDB")
    mh.parity_run(st)
    arrays = D.global_arrays(st.state)
    assert arrays["log_ptr"].shape == (8 * 4,)     # MDB: (n * partitions,)
    assert arrays["ov_ptr"].shape == (8,)
    assert arrays["keys"].shape == (8 * 8, 128)
    back = D.from_global_arrays(st._b.cfg, arrays, st._b.group)
    _assert_same_state(flatten(D.global_arrays(back)), flatten(arrays))
    with pytest.raises(ValueError, match="keys"):
        D.from_global_arrays(_cfg("MDB", n=4), arrays,
                             D.ShardGroup(4, ["cpu"]))
    st.close()


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------
def test_facade_matches_the_sim():
    """Read-your-writes before any flush, Δ-cancellation across shards and
    the merged contents all equal the sim's; the owner-aligned waves
    carry nothing and drop nothing."""
    cfg = D.ShardedTableConfig(
        local=tt.FlashTableConfig(q_log2=10, r_log2=7, scheme="MDB-L",
                                  log_capacity=1 << 14,
                                  max_updates_per_block=1 << 7,
                                  overflow_capacity=1 << 9),
        num_shards=8, bucket_cap=1 << 9)
    store = FlashStore.open(cfg, backend="sharded", device="cpu",
                            shard_chunk=512, flush_threshold=400)
    sim = FlashStore.open(backend="sim", scheme="MDB-L")
    toks = np.random.default_rng(0).integers(0, 5000, 8 * 2048)
    truth = Counter(toks.tolist())
    for i in range(0, toks.size, 2048):
        store.update(toks[i:i + 2048])
        sim.update(toks[i:i + 2048])
    keys = np.array(sorted(truth))
    want = np.array([truth[int(k)] for k in keys])
    np.testing.assert_array_equal(store.query(keys), want)
    dec = keys[::5]
    for st in (store, sim):
        st.update(dec, np.full(dec.size, -1, np.int64))
    np.testing.assert_array_equal(store.query(dec), want[::5] - 1)
    np.testing.assert_array_equal(store.query(dec), sim.query(dec))
    store.flush()
    sim.flush()
    np.testing.assert_array_equal(store.query(keys), sim.query(keys))
    s = store.stats()
    assert s["write_carried"] == 0 and s["dropped"] == 0
    assert s["write_auto_flushes"] >= 1
    store.close()
    sim.close()


def test_shard_local_thresholds():
    """One hot shard drains alone: the other shards' H_R partitions keep
    buffering, and the collective carries nothing."""
    st = FlashStore.open(tt.FlashTableConfig(**mh.table_kwargs("MDB-L")),
                         backend="sharded", device="cpu", num_shards=8,
                         shard_chunk=64, flush_threshold=64,
                         piggyback_frac=2.0)    # piggyback off: isolate
    b = st._b
    keys = np.arange(20_000)
    owners = b.owner_of(keys)
    hot = keys[owners == 0][:64]          # exactly the threshold
    cold = keys[owners != 0][:32]
    st.update(cold)
    assert st.buffered_entries == 32
    st.update(hot)                        # shard 0 reaches its threshold
    s = st.stats()
    assert s["write_auto_flushes"] == 1
    assert st.buffered_entries == 32      # the cold shards kept their H_R
    assert s["write_carried"] == 0
    np.testing.assert_array_equal(st.query(hot), np.ones(hot.size))
    np.testing.assert_array_equal(st.query(cold), np.ones(cold.size))
    st.close()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_one_shard_matches_the_device_backend(scheme):
    """One shard with shard_chunk = bucket_cap = the device engine's chunk
    stages the same padded chunks as the device backend: the same table,
    bit for bit, and the same answers."""
    table = tt.FlashTableConfig(**mh.table_kwargs(scheme))
    one = FlashStore.open(D.ShardedTableConfig(local=table, num_shards=1,
                                               bucket_cap=256),
                          backend="sharded", device="cpu", shard_chunk=256,
                          flush_threshold=300)
    dev = FlashStore.open(table, backend="device", device="cpu", chunk=256,
                          flush_threshold=300)
    for toks, d in mh.make_batches(seed=2, deltas=True):
        for st in (one, dev):
            st.update(toks, d)
    for st in (one, dev):
        st.flush()
    universe = np.arange(mh.UNIVERSE)
    np.testing.assert_array_equal(one.query(universe), dev.query(universe))
    _assert_same_state(_state(one),
                       flatten(convert.state_to_numpy(dev.state)))
    assert one.wear() == dev.wear()
    one.close()
    dev.close()


def test_sharded_store_refuses_what_it_cannot_do(tmp_path):
    with pytest.raises(ValueError, match="power of two"):
        FlashStore.open(backend="sharded", device="cpu", num_shards=6,
                        q_log2=10, r_log2=7)
    st = _open("MDB-L")
    st.update(np.arange(10))
    with pytest.raises(NotImplementedError, match="training slice"):
        st.snapshot(tmp_path, manager=object())
    st.close()


def test_sharded_wal_logs_one_record_per_part_and_restores(tmp_path):
    """Every sealed shard partition is its own WAL record (naming its
    part) with a commit once drained; a fresh store replays the log to
    the same answers."""
    wal = tmp_path / "sharded.wal"
    st = _open("MDB-L", wal=wal, flush_threshold=1 << 30)
    batches = mh.make_batches(seed=4, deltas=True)
    for toks, d in batches[:6]:
        st.update(toks, d)
        st.drain(wait=True)
    st._b._disp.close()                   # crash: nothing closed cleanly
    st.wal.close()
    records, _ = read_wal(wal)
    seals = [r for r in records if r.kind == SEAL]
    commits = [r for r in records if r.kind == COMMIT]
    assert {r.part for r in seals} == set(range(8))
    assert sorted(r.seq for r in commits) == sorted(r.seq for r in seals)
    st2 = _open("MDB-L", wal=wal, flush_threshold=1 << 30)
    rep = st2.restore()
    assert rep.records_replayed == len(seals)
    np.testing.assert_array_equal(st2.query(np.arange(mh.UNIVERSE)),
                                  mh.truth_of(batches[:6]))
    st2.close()


def test_tfidf_and_corpus_stats_sharded_match_the_device_backend():
    docs = [np.random.default_rng(i).zipf(1.3, 300) % 4000 for i in range(24)]
    kw = dict(q_log2=10, r_log2=6, log_capacity=512,
              max_updates_per_block=64, device="cpu")
    pipes = {b: TfIdfPipeline(backend=b, **kw, **(
        {"num_shards": 4, "shard_chunk": 128} if b == "sharded" else {}))
        for b in ("device", "sharded")}
    for p in pipes.values():
        for d in docs:
            p.add_document_ids(d)
        p.finalize()
    words = [str(w) for w in range(50)]
    scores = {b: p.idf_many(words) for b, p in pipes.items()}
    np.testing.assert_array_equal(scores["sharded"], scores["device"])
    q = np.arange(4000)
    np.testing.assert_array_equal(pipes["sharded"].term_table.query(q),
                                  pipes["device"].term_table.query(q))
    np.testing.assert_array_equal(pipes["sharded"].doc_table.query(q),
                                  pipes["device"].doc_table.query(q))
    for p in pipes.values():
        p.close()

    cfg = tt.FlashTableConfig(q_log2=10, r_log2=6, log_capacity=512)
    with pytest.raises(ValueError, match="single-table"):
        CorpusStats(cfg, state=tt.init(cfg, "cpu"), backend="sharded",
                    device="cpu")
    stats = {b: CorpusStats(cfg, backend=b, device="cpu")
             for b in ("device", "sharded")}
    for s in stats.values():
        for d in docs:
            s.ingest(d)
        s.flush()
    np.testing.assert_array_equal(stats["sharded"].tfidf_weights(q),
                                  stats["device"].tfidf_weights(q))
    assert (stats["sharded"].doc_score(docs[0])
            == stats["device"].doc_score(docs[0]))
    for s in stats.values():
        s.store.close()
