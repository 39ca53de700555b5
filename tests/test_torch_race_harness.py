"""The port's race harness against the reference's, on the CPU.

Twins of ``tests/test_race_harness.py`` on the port's stores
(``device="cpu"``: the flash-hash kernels' plain versions): the clean
device and sim runs and the 3-seed stress mix give no finding; the three
seeded interleavings — each a one-line regression of the store's
concurrency discipline, injected through monkeypatched hooks on a live
store — give the reference's finding kinds and counts. Last, the tracer
hooks themselves: on one op sequence, each thread's events (kind,
resource, read/write, meta) are the reference's, synchronous and
asynchronous."""
import threading

import numpy as np
import pytest
import torch

from repro.analysis import race_harness as ref_harness
from repro.core.store import FlashStore as RefFlashStore
from repro_torch.analysis import race_harness
from repro_torch.core.store import FlashStore

torch.set_num_threads(1)
GEOM = dict(backend="device", scheme="MDB-L", q_log2=8, r_log2=4,
            log_capacity=64, cs_partitions=4, max_updates_per_block=32,
            overflow_capacity=128, flush_threshold=10_000, chunk=256,
            query_chunk=256)


def _open_device(**kw):
    return FlashStore.open(**{**GEOM, "device": "cpu", **kw})


def _no_findings(tr):
    findings = tr.check()
    assert findings == [], "\n".join(f.describe() for f in findings)


# -- clean executions -------------------------------------------------------
def test_clean_run_device_zero_findings():
    st = _open_device()
    tr = race_harness.attach(st)
    st.update(np.arange(100))
    st.drain(wait=False)                 # overlapped drain
    st.update(np.arange(50, 150))
    assert st.query(7) == 1              # read-your-writes mid-flight
    st.flush()
    np.testing.assert_array_equal(st.query(np.arange(50, 60)),
                                  np.full(10, 2))
    assert st.query(55) == 2             # warm-cache path after a flush
    st.close()
    _no_findings(tr)
    kinds = {e.kind for e in tr.events}
    assert {"hr_write", "seal", "swap", "state_rebind", "inflight_clear",
            "invalidate", "cache_insert", "job_start", "job_end"} <= kinds


def test_clean_run_sim_zero_findings():
    st = FlashStore.open(backend="sim", scheme="MDB-L")
    tr = race_harness.attach(st)
    st.update(np.arange(64))
    st.drain(wait=False)
    st.update(np.arange(32, 96))
    assert st.query(40) == 2
    st.flush()
    st.close()
    _no_findings(tr)
    assert {"seal", "inflight_clear"} <= {e.kind for e in tr.events}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_stress_interleaving_zero_findings(seed):
    """A randomized update/drain/query/flush mix (auto-flush threshold
    deliberately low so drains overlap ingest) gives a race-free log on
    every seed."""
    rng = np.random.default_rng(seed)
    st = _open_device(flush_threshold=64)
    tr = race_harness.attach(st)
    for _ in range(40):
        op = int(rng.integers(0, 4))
        if op == 0:
            st.update(rng.integers(0, 256, size=48))
        elif op == 1:
            st.drain(wait=False)
        elif op == 2:
            st.query(rng.integers(0, 256, size=16))
        else:
            st.flush(wait=bool(rng.integers(0, 2)))
    st.close()
    _no_findings(tr)


# -- seeded interleaving 1: invalidate *before* rebind ----------------------
def test_seeded_invalidate_before_rebind_is_flagged():
    """A drain that invalidates first and rebinds after leaves a window
    where the cache repopulates from the pre-drain state: the checker
    flags the ordering, whatever the timing."""
    st = _open_device()
    eng = st._b.writer
    tr = race_harness.attach(st)
    st.update(np.arange(64))
    orig = eng._dispatch

    def bad_dispatch(keys, dels):
        eng._invalidate()                      # fence first (the bug)
        qe, eng.query_engine = eng.query_engine, None
        try:
            orig(keys, dels)                   # ...rebind after, unfenced
        finally:
            eng.query_engine = qe

    eng._dispatch = bad_dispatch
    st.drain(wait=True)
    findings = tr.check()
    assert {f.kind for f in findings} == {"unfenced-rebind"}
    assert len(findings) == 1
    assert "rebound" in findings[0].message
    eng._dispatch = orig
    st.close()


# -- seeded interleaving 2: double seal without settling --------------------
def test_seeded_double_seal_without_settle_is_flagged():
    """Sealing H_R while the previous sealed chunk still drains: the
    worker's in-flight clear and the caller's re-seal write the same slot
    with no happens-before edge. A gate holds the worker so the bad
    interleaving is deterministic."""
    st = _open_device()
    eng = st._b.writer
    tr = race_harness.attach(st)
    gate = threading.Event()
    orig = eng._dispatch

    eng.update(np.arange(32))
    sealed = eng.seal()

    def gated_drain():
        gate.wait(timeout=30)
        orig(*sealed)

    eng.dispatcher.submit(gated_drain, label="gated-drain#1")
    eng.update(np.arange(100, 140))
    # the seeded bug: re-seal without settling the in-flight drain
    # (defeating the clobber guard the way a broken refactor would)
    eng.front._inflight[0] = None
    eng.seal()
    gate.set()
    eng.dispatcher.wait()
    findings = tr.check()
    assert {f.kind for f in findings} == {"data-race"}
    assert len(findings) == 1
    assert "hr:inflight" in findings[0].message
    assert {e.resource for e in findings[0].events} == {"hr:inflight"}
    st.close()


# -- seeded interleaving 3: cache insert across an un-fenced clear ----------
def test_seeded_stale_cache_insert_is_flagged():
    """An invalidation that clears the hot cache but forgets the epoch
    bump: a lookup already in flight passes the fence and re-caches
    counts probed against the pre-clear state."""
    st = _open_device()
    qe = st._b.query_engine
    tr = race_harness.attach(st)
    st.update(np.arange(64))
    st.flush()                           # 2 invalidations, epoch == 2

    orig_lookup = qe._lookup
    fired = []

    def bad_lookup(state, q):
        out = orig_lookup(state, q)
        if not fired:                    # mid-lookup, exactly once
            fired.append(1)
            # the seeded bug: clear without bumping the epoch fence
            qe._trace("invalidate", "cache", "w", epoch=qe._epoch)
            qe._hot.clear()
        return out

    qe._lookup = bad_lookup
    st.query(np.arange(16))
    findings = tr.check()
    assert {f.kind for f in findings} == {"stale-cache-insert"}
    assert len(findings) == 1
    assert "epoch" in findings[0].message
    qe._lookup = orig_lookup
    st.close()


# -- harness plumbing -------------------------------------------------------
def test_attach_rejects_dispatcherless_objects():
    with pytest.raises(ValueError, match="no FlushDispatcher"):
        race_harness.attach(object())


def test_vector_clock_orderings():
    a, b = {1: 2, 2: 1}, {1: 3, 2: 1}
    assert race_harness._leq(a, b) and not race_harness._leq(b, a)
    assert not race_harness._concurrent(a, b)
    assert race_harness._concurrent({1: 1}, {2: 1})
    assert not race_harness._concurrent(a, a)


def test_untraced_store_records_nothing_and_keeps_its_answers():
    """The hooks are ``None`` tests when no tracer is attached: a store
    without one answers as a traced one does."""
    answers = []
    for traced in (False, True):
        st = _open_device(flush_threshold=64)
        tr = race_harness.attach(st) if traced else None
        assert (st._b._disp.tracer is tr
                and st._b.query_engine.tracer is tr)
        _ops(st, async_reads=True)
        answers.append((st.query(np.arange(300)).tolist(), st.wear()))
        st.close()
    assert answers[0] == answers[1]


# -- the hooks against the reference's --------------------------------------
def _ops(st, async_reads: bool) -> None:
    """One op sequence. Without ``async_reads`` every read follows a
    barrier, so each thread's events are deterministic with a worker."""
    st.update(np.arange(100))
    st.drain(wait=False)
    st.update(np.arange(50, 150))
    if async_reads:
        st.query(np.arange(40))
    st.drain(wait=False)                 # settles the first drain
    st.update(np.arange(120, 200))
    st.flush(wait=False)
    st.flush()
    st.query(np.arange(0, 220, 3))
    st.query(np.arange(0, 220, 3))       # warm cache
    st.update(np.arange(10))
    st.query(np.arange(5, 15))           # cache read + H_R overlay
    st.flush()


def _per_thread(events):
    """Each thread's ``(kind, resource, rw, meta)`` in program order,
    threads in order of their first event."""
    out = {}
    for e in events:
        out.setdefault(e.thread, []).append(
            (e.kind, e.resource, e.rw, e.meta))
    return list(out.values())


@pytest.mark.parametrize("async_flush", [False, True])
def test_events_match_reference_per_thread(async_flush):
    logs = []
    for harness, Store, extra in ((ref_harness, RefFlashStore, {}),
                                  (race_harness, FlashStore,
                                   {"device": "cpu"})):
        st = Store.open(**{**GEOM, **extra}, async_flush=async_flush)
        tr = harness.attach(st)
        _ops(st, async_reads=False)
        st.close()
        assert tr.check() == []
        logs.append(_per_thread(tr.events))
    ref, port = logs
    assert len(port) == (2 if async_flush else 1)
    assert port == ref
    kinds = {k for thread in port for k, *_ in thread}
    assert {"hr_write", "swap", "seal", "job_start", "state_rebind",
            "inflight_clear", "invalidate", "job_end", "hr_read",
            "cache_read", "lookup_begin", "cache_insert"} <= kinds
