"""The port's durability surface, on the CPU: the write-ahead log, store
snapshot / restore on the ``sim`` and ``device="cpu"`` backends, poison
recovery, the ``CorpusStats`` and ``PrefixKVCache`` snapshots, and the
boundary with the reference package:

* the port's WAL file is byte-identical to the reference's for the same
  stream through the same backend kind;
* a device snapshot written by either package restores in the other,
  with identical counts and state arrays.

The recovery contract under test: everything sealed before a crash is
recoverable (seal records are fsync'd before the drain dispatches), and
replay is idempotent (restore twice, restore after a clean close,
restore over a snapshot all agree)."""
import os

import numpy as np
import pytest
import torch

from repro.core import table_jax as tj
from repro.core.store import FlashStore as RefStore
from repro_torch import convert
from repro_torch.core import table_torch as tt
from repro_torch.core.store import DrainError, FlashStore
from repro_torch.core.wal import MAGIC, SEAL, WriteAheadLog, read_wal

torch.set_num_threads(1)

TABLE = dict(q_log2=10, r_log2=6, log_capacity=1 << 9, cs_partitions=4,
             max_updates_per_block=1 << 6, overflow_capacity=1 << 9)
SCHEMES = ["MB", "MDB", "MDB-L"]
BACKENDS = ["sim", "device"]


def _open(backend, scheme="MDB-L", **kw):
    kw.setdefault("flush_threshold", 10_000)   # no surprise auto-drains
    if backend == "sim":
        return FlashStore.open(backend="sim", scheme=scheme, **kw)
    kw.setdefault("chunk", 128)
    return FlashStore.open(tt.FlashTableConfig(scheme=scheme, **TABLE),
                           backend="device", device="cpu", **kw)


def _open_ref(backend, scheme="MDB-L", **kw):
    kw.setdefault("flush_threshold", 10_000)
    if backend == "sim":
        return RefStore.open(backend="sim", scheme=scheme, **kw)
    kw.setdefault("chunk", 128)
    return RefStore.open(tj.FlashTableConfig(scheme=scheme, **TABLE),
                         backend="device", **kw)


# ---------------------------------------------------------------------------
# the log itself
# ---------------------------------------------------------------------------
def test_wal_roundtrip_and_watermarks(tmp_path):
    p = tmp_path / "w.wal"
    w = WriteAheadLog(p)
    s1 = w.append_seal(0, np.array([3, 1, 2]), np.array([1, 1, -1]))
    s2 = w.append_seal(1, np.array([9]), np.array([5]))
    w.sync()
    assert (s1, s2) == (1, 2)
    assert w.last_seq == 2 and w.committed_seq == 0
    w.append_commit(0, s1)
    assert w.committed_seq == 1          # s2 uncommitted blocks the prefix
    w.append_commit(1, s2)
    assert w.committed_seq == 2
    w.close()
    assert w.closed and w.fsync

    records, discarded = read_wal(p)
    assert discarded == 0
    assert [r.kind for r in records] == [SEAL, SEAL, 2, 2]
    np.testing.assert_array_equal(records[0].keys, [3, 1, 2])
    np.testing.assert_array_equal(records[0].deltas, [1, 1, -1])
    assert records[1].part == 1

    # reopen resumes sequencing after the last intact record
    w2 = WriteAheadLog(p)
    assert w2.last_seq == 2 and w2.committed_seq == 2
    assert w2.append_seal(0, np.array([7]), np.array([1])) == 3
    with w2.suppressed():
        assert w2.append_seal(0, np.array([8]), np.array([1])) is None
    w2.close()


def test_wal_missing_file_reads_empty_and_bad_magic_raises(tmp_path):
    assert read_wal(tmp_path / "nope.wal") == ([], 0)
    bad = tmp_path / "bad.wal"
    bad.write_bytes(b"NOTAWAL!" + b"\x00" * 32)
    with pytest.raises(ValueError, match="magic"):
        read_wal(bad)


def test_wal_torn_tail_discarded_loudly(tmp_path):
    """A crash mid-append leaves a non-record-aligned tail: the intact
    prefix survives, the tail is dropped with a warning, and reopening
    truncates so new appends land on a clean boundary."""
    p = tmp_path / "torn.wal"
    w = WriteAheadLog(p)
    w.append_seal(0, np.array([1, 2]), np.array([1, 1]))
    w.append_seal(0, np.array([3, 4, 5]), np.array([1, 1, 1]))
    w.sync()
    w.close()
    p.write_bytes(p.read_bytes()[:-7])   # tear the last record's payload

    with pytest.warns(UserWarning, match="torn WAL tail"):
        records, discarded = read_wal(p)
    assert discarded > 0
    assert [r.seq for r in records] == [1]

    with pytest.warns(UserWarning, match="torn WAL tail"):
        w2 = WriteAheadLog(p)
    assert w2.last_seq == 1
    assert w2.append_seal(0, np.array([9]), np.array([1])) == 2
    w2.close()
    records, discarded = read_wal(p)     # clean again after truncation
    assert discarded == 0 and [r.seq for r in records] == [1, 2]


def test_after_sync_hook_fires_once_per_seal_event_and_quiesce_joins(
        tmp_path):
    st = _open("device", wal=tmp_path / "h.wal")
    events = []
    st.wal.after_sync = events.append
    for i in range(3):
        st.update(np.arange(10 * i, 10 * i + 10))
        st.drain(wait=False)
    st.quiesce()                         # joins the in-flight drain
    assert not st._b._disp.pending
    assert events == [1, 2, 3] and st.wal.seal_events == 3
    assert st.wal.committed_seq == 3     # every drain logged its commit
    st.close()


# ---------------------------------------------------------------------------
# restore: replay semantics + idempotence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_without_snapshot_replays_wal(tmp_path, backend):
    wal = tmp_path / "s.wal"
    st = _open(backend, wal=wal)
    st.update(np.arange(100), np.ones(100, np.int64))
    st.drain(wait=True)
    st.update(np.arange(50), np.full(50, 2, np.int64))
    st.drain(wait=True)
    assert st.wal.last_seq >= 2
    st.close()                           # WAL survives a clean close

    st2 = _open(backend, wal=wal)
    rep = st2.restore()                  # no snapshot: fresh init + replay
    assert rep.snapshot_step is None
    assert rep.records_replayed >= 2
    assert rep.entries_replayed == 150
    assert int(st2.query(5)) == 3 and int(st2.query(75)) == 1

    rep2 = st2.restore()                 # idempotent: replays the same log
    assert rep2.entries_replayed == rep.entries_replayed
    assert int(st2.query(5)) == 3 and int(st2.query(75)) == 1
    st2.close()


@pytest.mark.parametrize("backend,scheme",
                         [(b, s) for b in BACKENDS for s in SCHEMES])
def test_snapshot_restore_with_post_snapshot_wal(tmp_path, backend, scheme):
    """Snapshot rotates the WAL; deltas sealed afterwards replay on top
    of the restored snapshot — no lost and no double-applied chunks."""
    wal = tmp_path / "s.wal"
    snap = tmp_path / "snap"
    st = _open(backend, scheme=scheme, wal=wal)
    st.update(np.arange(100), np.ones(100, np.int64))
    st.drain(wait=True)
    st.snapshot(snap)
    assert os.path.getsize(wal) == len(MAGIC)    # rotated
    st.update(np.arange(30), np.full(30, 4, np.int64))
    st.drain(wait=True)
    st.close()

    st2 = _open(backend, scheme=scheme, wal=wal)
    rep = st2.restore(snap)
    assert rep.snapshot_step == 0
    assert rep.records_replayed >= 1 and rep.entries_replayed == 30
    assert rep.meta["store_backend"] == backend
    assert int(st2.query(5)) == 5        # 1 from snapshot + 4 replayed
    assert int(st2.query(60)) == 1       # snapshot only
    st2.close()


def test_restore_after_clean_close_is_noop_replay(tmp_path):
    """snapshot() then close(): the WAL is empty, restore is a pure
    snapshot load — zero records replayed."""
    wal = tmp_path / "s.wal"
    snap = tmp_path / "snap"
    st = _open("sim", wal=wal)
    st.update(np.arange(40))
    st.snapshot(snap)
    st.close()

    st2 = _open("sim", wal=wal)
    rep = st2.restore(snap)
    assert rep.records_replayed == 0 and rep.entries_replayed == 0
    assert int(st2.query(7)) == 1
    st2.close()


def test_restore_clears_poison_and_rearms(tmp_path):
    """A poisoned store (the drain worker died) stays wedged until
    restore() clears the poison, re-arms the dispatcher and recovers the
    sealed chunk from the WAL, leaving the store usable."""
    wal = tmp_path / "s.wal"
    st = _open("device", wal=wal)
    st.update(np.arange(10))
    # consume the store's state behind its back (its successor dropped)
    tt.update(st.cfg, st.state, torch.tensor([999], dtype=torch.int32))
    st.drain(wait=False)                 # the state was consumed: dies
    with pytest.raises(DrainError, match="donated"):
        st.flush(wait=True)
    with pytest.raises(RuntimeError, match="poisoned"):
        st.flush()                       # wedged: every drain path raises
    with pytest.raises(RuntimeError, match="poisoned"):
        st.quiesce()                     # a snapshot would miss the chunk
    assert st._b.front.poisoned

    rep = st.restore()                   # same store object, in place
    assert rep.poison_cleared
    assert rep.entries_replayed == 10    # the poisoned chunk was logged
    assert not st._b.front.poisoned
    np.testing.assert_array_equal(st.query(np.arange(10)), np.ones(10))
    st.update(np.asarray([3]))           # usable again
    st.flush(wait=True)                  # fresh worker drains fine
    assert int(st.query(3)) == 2
    st.close()                           # clean close, no re-raise


def test_restore_reopens_a_closed_store(tmp_path):
    wal = tmp_path / "s.wal"
    st = _open("sim", wal=wal)
    st.update(np.arange(20))
    st.drain(wait=True)
    st.close()
    with pytest.raises(ValueError):
        st.update(np.asarray([1]))
    st.restore()                         # reopen + replay in place
    assert int(st.query(3)) == 1
    st.update(np.asarray([3]))           # WAL reopened: new seals log again
    st.drain(wait=True)
    assert st.wal.last_seq >= 2
    st.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_seals_after_a_restore_onto_a_rotated_log_replay(tmp_path, backend):
    """A log reopened after its rotation holds no record, so it would
    number new seals from 1 again, at or below the snapshot's base; the
    restore numbers them past the base, so a second crash replays them.
    (The reference numbers from 1 here and loses those seals.)"""
    wal = tmp_path / "s.wal"
    snap = tmp_path / "snap"
    st = _open(backend, wal=wal)
    for _ in range(3):
        st.update(np.arange(20), np.ones(20, np.int64))
        st.drain(wait=True)
    st.snapshot(snap)                    # the log rotates to its magic
    base = st.wal.last_seq
    assert base >= 3
    st.close()

    st2 = _open(backend, wal=wal)        # first crash: reopen, restore
    assert st2.wal.last_seq == 0
    assert st2.restore(snap).records_replayed == 0
    st2.update(np.arange(10), np.full(10, 5, np.int64))
    st2.drain(wait=True)                 # sealed: only the log holds it
    assert st2.wal.last_seq == base + 1
    st2.close()                          # second crash: no snapshot since

    st3 = _open(backend, wal=wal)
    rep = st3.restore(snap)
    assert rep.records_replayed == 1 and rep.entries_replayed == 10
    np.testing.assert_array_equal(st3.query(np.arange(20)),
                                  np.r_[np.full(10, 8), np.full(10, 3)])
    st3.close()


def test_restored_table_lands_on_the_backend_device(tmp_path):
    """A backend built from a passed-in state remembers its device; a
    snapshot of another geometry is refused; ``manager=`` waits for the
    training slice."""
    cfg = tt.FlashTableConfig(scheme="MB", **TABLE)
    state = tt.init(cfg, "cpu")
    st = FlashStore.open(cfg, device="cpu", state=state)
    assert st._b.device == torch.device("cpu")
    st.update(np.arange(64))
    st.snapshot(tmp_path / "snap")
    rep = st.restore(tmp_path / "snap")
    assert rep.snapshot_step == 0 and st.state.device.type == "cpu"
    assert st.state.log_ptr.dim() == 0 and st.state.stats.merges.dim() == 0
    np.testing.assert_array_equal(st.query(np.arange(64)), np.ones(64))
    with pytest.raises(NotImplementedError, match="Training"):
        st.snapshot(tmp_path / "snap2", manager=object())
    st.close()
    other = FlashStore.open(tt.FlashTableConfig(
        scheme="MB", **{**TABLE, "q_log2": 11}), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        other.restore(tmp_path / "snap")
    other.close()


# ---------------------------------------------------------------------------
# unified snapshot surface
# ---------------------------------------------------------------------------
def test_corpus_stats_snapshot_roundtrip(tmp_path):
    from repro_torch.data.stats import CorpusStats
    cfg = tt.FlashTableConfig(scheme="MDB-L", **TABLE)
    cs = CorpusStats(cfg, device="cpu", wal=tmp_path / "cs.wal")
    cs.ingest(np.arange(64))
    cs.ingest(np.arange(32))
    cs.snapshot(tmp_path / "snap")
    cs.ingest(np.arange(8))              # sealed after the snapshot
    cs.store.drain()
    cs.store.close()

    cs2 = CorpusStats(cfg, device="cpu", wal=tmp_path / "cs.wal")
    rep = cs2.restore(tmp_path / "snap")
    assert (cs2.docs_seen, cs2.tokens_seen) == (2, 96)
    assert rep.meta["docs_seen"] == 2 and rep.entries_replayed == 8
    np.testing.assert_array_equal(cs2.counts(np.arange(8)), np.full(8, 3))
    np.testing.assert_array_equal(cs2.counts(np.arange(8, 32)),
                                  np.full(24, 2))
    np.testing.assert_array_equal(cs2.counts(np.arange(32, 64)), np.ones(32))
    cs2.store.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefix_cache_snapshot_roundtrip_matches_reference(tmp_path,
                                                           backend):
    from repro.serving.prefix_cache import PrefixKVCache as RefCache
    from repro_torch.serving.prefix_cache import PrefixKVCache
    kw = dict(block_tokens=4, capacity_blocks=16, backend=backend)
    toks = list(range(12))
    slicer = lambda v, n: {"kv": v["kv"][: n // 4]}
    out = {}
    for name, mk in (("ref", lambda: RefCache(**kw)),
                     ("port", lambda: PrefixKVCache(
                         **kw, **({"device": "cpu"} if backend == "device"
                                  else {})))):
        c = mk()
        keys = c.insert(toks, value={"kv": np.arange(3)}, slicer=slicer)
        n, _val, pinned = c.acquire(toks)
        assert n == 12
        c.snapshot(tmp_path / name)
        c._refs.close()

        c2 = mk()
        c2.restore(tmp_path / name)
        assert set(c2.store) == set(keys)
        assert (c2.hits, c2.misses) == (c.hits, c.misses)
        n2, val2, _ = c2.acquire(toks)   # refcounts restored through store
        assert n2 == 12
        np.testing.assert_array_equal(val2["kv"], np.arange(3))
        counts = c2._refs.query_batch(np.asarray(keys, np.int64))
        out[name] = (sorted(c2.store), counts.tolist(), c2.hits, c2.misses,
                     sorted(p.name for p in (tmp_path / name).iterdir()))
        c2._refs.close()
    assert out["port"] == out["ref"]
    assert min(out["port"][1]) >= 1      # insert + acquire pins survived


# ---------------------------------------------------------------------------
# the boundary with the reference package
# ---------------------------------------------------------------------------
def _wal_stream():
    rng = np.random.default_rng(11)
    for i in range(5):
        yield (rng.integers(0, 700, 150).astype(np.int64),
               rng.choice(np.array([1, 1, 2, -1], np.int64), 150), i)


@pytest.mark.parametrize("backend", BACKENDS)
def test_wal_bytes_equal_the_reference(tmp_path, backend):
    logs = {}
    for name, mk in (("port", _open), ("ref", _open_ref)):
        st = mk(backend, scheme="MDB", wal=tmp_path / f"{name}.wal",
                flush_threshold=200)
        for toks, dels, i in _wal_stream():
            st.update(toks, dels)
            if i % 2:
                st.drain(wait=False)
        st.flush()
        st.close()
        logs[name] = (tmp_path / f"{name}.wal").read_bytes()
    assert logs["port"] == logs["ref"]
    records, discarded = read_wal(tmp_path / "port.wal")
    assert discarded == 0 and sum(r.kind == SEAL for r in records) >= 3


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_device_snapshot_restores_across_packages(tmp_path, writer, scheme):
    """A device snapshot written by one package restores in the other:
    identical counts, and ``state_to_numpy`` equal to the writer's
    arrays."""
    snap = tmp_path / "snap"
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 900, 200).astype(np.int64),
                rng.choice(np.array([1, 2, -1], np.int64), 200))
               for _ in range(4)]
    src = (_open_ref if writer == "ref" else _open)("device", scheme)
    for toks, dels in batches[:3]:
        src.update(toks, dels)
        src.drain()
    src.snapshot(snap)
    src.update(*batches[3])              # unsealed at the snapshot
    src.drain()
    keys = np.arange(-1, 1000)
    want = src.query(keys)
    st = src.state
    want_arrays = (convert.state_to_numpy(st) if writer == "port"
                   else _ref_arrays(st))
    src.close()

    dst = (_open if writer == "ref" else _open_ref)("device", scheme)
    rep = dst.restore(snap)
    assert rep.snapshot_step == 0
    for toks, dels in batches[3:]:
        dst.update(toks, dels)
        dst.drain()
    np.testing.assert_array_equal(dst.query(keys), want)
    got = (convert.state_to_numpy(dst.state) if writer == "ref"
           else _ref_arrays(dst.state))
    for f in ("keys", "counts", "log_keys", "log_counts", "log_ptr",
              "ov_keys", "ov_counts", "ov_ptr", "filter_words"):
        np.testing.assert_array_equal(got[f], want_arrays[f], err_msg=f)
        assert got[f].dtype == want_arrays[f].dtype, f
    gs, ws = got["stats"], want_arrays["stats"]
    for f in ("tile_loads", "tile_stores", "staged_entries", "merges",
              "stages", "dropped", "carried"):
        assert int(np.asarray(_field(gs, f))) == int(
            np.asarray(_field(ws, f))), f
    dst.close()


def _ref_arrays(state) -> dict:
    """A reference state as numpy copies (its buffers are donated)."""
    import jax
    return jax.tree.map(lambda a: np.array(a, copy=True), state)._asdict()


def _field(rec, name):
    return rec[name] if isinstance(rec, dict) else getattr(rec, name)
