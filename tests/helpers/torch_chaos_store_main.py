"""Chaos victim of the PyTorch port: SIGKILL a FlashStore between seal and
drain.

Usage: ``python torch_chaos_store_main.py <backend> <scheme> <wal_path>
<kill_after> [snapshot_path <snap_after>]``

Ingests a fixed seeded stream of ±Δ batches, draining after each with
``wait=False`` (the async path). The WAL's ``after_sync`` hook — which
fires once per seal *event*, right after the seal record is fsync'd and
strictly before the drain is submitted — SIGKILLs this process at seal
event ``kill_after``. The log then holds exactly batches 1..kill_after:
batch ``kill_after`` was sealed and logged but its drain never ran. With
``snapshot_path``, a snapshot is taken after batch ``snap_after``
(rotating the WAL mid-stream) so restore must combine snapshot + replay.
The ``device`` backend runs on the CPU (the kernels' plain versions).

It imports only the port (``repro_torch``), never the reference package
or JAX. The parent (``tests/test_torch_chaos.py``) imports this module for
``make_batches`` / ``open_store`` so the truth it computes is the stream
the killed process saw.
"""
import os
import signal
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402

BATCHES = 6
BATCH = 200
KEYSPACE = 300


def make_batches():
    """The seeded stream, identical in child and parent: skewed tokens,
    ±Δ deltas (so cancellation is exercised inside the sealed chunks)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(BATCHES):
        toks = rng.integers(0, KEYSPACE, size=BATCH).astype(np.int64)
        dels = rng.choice(np.array([1, 1, 2, -1], np.int64), size=BATCH)
        out.append((toks, dels))
    return out


def open_store(backend, scheme, wal_path):
    from repro_torch.core import table_torch as tt
    from repro_torch.core.store import FlashStore
    # threshold high enough that only the explicit per-batch drains seal:
    # the kill-point accounting is one seal event per batch
    if backend == "sim":
        return FlashStore.open(backend="sim", scheme=scheme, wal=wal_path,
                               flush_threshold=10_000)
    cfg = tt.FlashTableConfig(q_log2=10, r_log2=6, scheme=scheme,
                              log_capacity=1 << 9, cs_partitions=4,
                              max_updates_per_block=1 << 6,
                              overflow_capacity=1 << 9)
    return FlashStore.open(cfg, backend="device", device="cpu", chunk=128,
                           wal=wal_path, flush_threshold=10_000)


def main():
    import torch
    torch.set_num_threads(1)
    backend, scheme, wal_path, kill_after = sys.argv[1:5]
    kill_after = int(kill_after)
    snap_path = sys.argv[5] if len(sys.argv) > 5 else None
    snap_after = int(sys.argv[6]) if len(sys.argv) > 6 else 0
    st = open_store(backend, scheme, wal_path)

    def maybe_kill(seal_events):
        if seal_events == kill_after:
            # no atexit, no cleanup, no flush: the real failure mode
            os.kill(os.getpid(), signal.SIGKILL)

    st.wal.after_sync = maybe_kill
    for i, (toks, dels) in enumerate(make_batches(), start=1):
        st.update(toks, dels)
        st.drain(wait=False)             # seals (fsync, hook) then drains
        if snap_path is not None and i == snap_after:
            st.snapshot(snap_path)       # rotates the WAL mid-stream
    print("NEVER_KILLED", flush=True)    # the parent asserts we died


if __name__ == "__main__":
    main()
