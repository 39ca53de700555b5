"""Chaos lane of the port: SIGKILL mid-drain, restore, assert nothing lost
or double-applied.

A subprocess (``tests/helpers/torch_chaos_store_main.py``, which imports
only the port) ingests a seeded stream and is SIGKILLed by the WAL's
``after_sync`` hook at a chosen seal event — after the sealed chunk's
record is durable, before its drain runs. The parent then opens a fresh
store over the same WAL, ``restore()``s, and checks the recovered
contents:

* against the recomputed truth (per-key delta sums of batches
  1..kill_after) over the full keyspace — zero lost, double-applied or
  phantom deltas;
* against the port's sim store fed the same batches (the oracle).

The snapshot variant rotates the WAL mid-stream so restore must stitch
snapshot + replayed tail."""
import importlib.util
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

HELPER = (Path(__file__).resolve().parent / "helpers"
          / "torch_chaos_store_main.py")

_spec = importlib.util.spec_from_file_location("torch_chaos_store_main",
                                               HELPER)
chaos = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chaos)

CASES = [(b, s) for b in ("sim", "device") for s in ("MB", "MDB", "MDB-L")]

# seeded kill points: early / mid / late WAL tails, per scheme
KILL_AFTER = {"MB": 2, "MDB": 3, "MDB-L": 4}


def _run_victim(wal_path, backend, scheme, kill_after, extra=()):
    return subprocess.run(
        [sys.executable, str(HELPER), backend, scheme, str(wal_path),
         str(kill_after), *map(str, extra)],
        capture_output=True, text=True, timeout=120, env=dict(os.environ))


def _truth(n_batches):
    """Per-key delta sums of batches 1..n_batches over the full keyspace."""
    sums = Counter()
    for toks, dels in chaos.make_batches()[:n_batches]:
        for t, d in zip(toks.tolist(), dels.tolist()):
            sums[t] += d
    keys = np.arange(chaos.KEYSPACE, dtype=np.int64)
    return keys, np.array([sums[int(k)] for k in keys], np.int64)


def _oracle(scheme, n_batches, keys):
    """The port's sim store fed the same stream."""
    st = chaos.open_store("sim", scheme, None)
    try:
        for toks, dels in chaos.make_batches()[:n_batches]:
            st.update(toks, dels)
        st.flush(wait=True)
        return np.asarray(st.query_batch(keys), np.int64)
    finally:
        st.close()


def _killed(proc):
    assert proc.returncode == -9, (
        f"victim survived (rc={proc.returncode})\n"
        f"stdout: {proc.stdout}\nstderr: {proc.stderr}")
    assert "NEVER_KILLED" not in proc.stdout


@pytest.mark.parametrize("backend,scheme", CASES,
                         ids=[f"{b}-{s}" for b, s in CASES])
def test_sigkill_between_seal_and_drain(tmp_path, backend, scheme):
    kill_after = KILL_AFTER[scheme]
    wal = tmp_path / "chaos.wal"
    _killed(_run_victim(wal, backend, scheme, kill_after))
    assert wal.exists() and wal.stat().st_size > 8  # magic + records

    st = chaos.open_store(backend, scheme, wal)
    try:
        rep = st.restore()
        assert rep.snapshot_step is None            # no snapshot was taken
        assert rep.tail_discarded_bytes == 0        # kill was post-fsync
        assert rep.records_replayed >= kill_after
        keys, want = _truth(kill_after)
        got = np.asarray(st.query_batch(keys), np.int64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _oracle(scheme, kill_after, keys))
        # the store is live after restore: it can keep ingesting
        st.update(np.array([7, 7], np.int64))
        st.flush(wait=True)
        assert int(st.query_batch(np.array([7], np.int64))[0]) == want[7] + 2
    finally:
        st.close()


def test_sigkill_after_midstream_snapshot(tmp_path):
    """Snapshot rotates the WAL mid-stream; the crash lands two batches
    later, so recovery = snapshot(1..2) + WAL replay(3..4)."""
    backend, scheme, snap_after, kill_after = "device", "MDB-L", 2, 4
    wal = tmp_path / "chaos.wal"
    snap = tmp_path / "snap"
    _killed(_run_victim(wal, backend, scheme, kill_after,
                        extra=(snap, snap_after)))

    st = chaos.open_store(backend, scheme, wal)
    try:
        rep = st.restore(snap)
        assert rep.snapshot_step is not None
        assert rep.records_replayed == kill_after - snap_after
        keys, want = _truth(kill_after)
        got = np.asarray(st.query_batch(keys), np.int64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _oracle(scheme, kill_after, keys))
        assert st.wear()["dropped"] == 0
    finally:
        st.close()
