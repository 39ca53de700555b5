"""The port's sharded FlashStore over several processes (torch.distributed).

The parent (``--role parent``, the default) starts two ``--role worker``
processes. Each joins one gloo process group over a localhost TCP
address (``MASTER_PORT`` is a free port the parent picks) and holds 4
of the store's 8 shards on the CPU. The parent then compares what the
workers dumped with the truth, the port's single-process 8-shard store
and the port's sim. Scenarios:

``equivalence``  ranks ingest alternate batches of one ±Δ stream, drain
                 together every 4 batches, flush; the final contents
                 equal the truth, the single-process store's and the
                 sim's; ``write_carried == 0`` and nothing dropped on
                 every rank.
``heat``         the whole skewed trace lands on rank 0 (rank 1 joins
                 the collectives with nothing sealed): per-key
                 ``partition_heat`` equals the single-process store's.
``wal_restore``  each rank seals through its own WAL; the stores are
                 abandoned unclosed; fresh stores replay their own logs
                 (the drains in lockstep) and give the truth.
``handoff``      a departed store's WAL is re-owned by both ranks
                 through ``elastic.handoff_hr_partitions``: disjoint
                 round-robin slices, every record exactly once.

Every child runs under a wall-clock limit with ``faulthandler`` armed, so
a collective that hangs fails with its stacks instead of hanging.

It imports only the port, never the reference package or JAX; the
reference's side of the parity tests imports this module for the stream
and the table geometry (``make_batches``, ``table_kwargs``,
``parity_run``), which need numpy alone.
"""
import argparse
import faulthandler
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
UNIVERSE = 5000          # key space of every stream below
N_BATCHES = 16
BATCH = 1024
NUM_PROCS = 2
NUM_SHARDS = 8
BUCKET_CAP = 1 << 9
CHILD_TIMEOUT = 240      # seconds a child may take before it is killed
#: the parity run's store: small waves and shard-local thresholds low
#: enough that auto-drains, piggybacking and several waves a drain happen
PARITY = dict(shard_chunk=64, flush_threshold=100)


# ---------------------------------------------------------------------------
# shared deterministic inputs (every role regenerates them from the seed)
# ---------------------------------------------------------------------------
def make_batches(seed: int = 0, deltas: bool = False):
    """N_BATCHES (tokens, deltas or None) batches over a skewed key space.
    With ``deltas`` the last batch decrements every third key the stream
    touched (deletion by decrement), so net counts stay non-negative."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_BATCHES - (1 if deltas else 0)):
        toks = (rng.zipf(1.3, size=BATCH) % UNIVERSE).astype(np.int64)
        d = (rng.choice(np.array([1, 1, 2], np.int64), BATCH) if deltas
             else None)
        out.append((toks, d))
    if deltas:
        seen = np.unique(np.concatenate([t for t, _ in out]))[::3]
        dec = seen[:BATCH]
        out.append((dec.astype(np.int64), np.full(dec.size, -1, np.int64)))
    return out


def truth_of(batches) -> np.ndarray:
    """Net count of every key of the universe."""
    out = np.zeros(UNIVERSE, np.int64)
    for toks, d in batches:
        np.add.at(out, toks, 1 if d is None else d)
    return out


def table_kwargs(scheme: str) -> dict:
    """Each shard's table: 8 blocks of 128 slots. MDB-L's log takes two
    waves of received buckets; MDB's 4 partitions of 128 fill and merge."""
    kw = dict(q_log2=10, r_log2=7, scheme=scheme,
              log_capacity=1 << 13, max_updates_per_block=1 << 7,
              overflow_capacity=1 << 9)
    if scheme == "MDB":
        kw.update(log_capacity=1 << 9, cs_partitions=4)
    return kw


def parity_run(store):
    """The parity stream through ``store`` (either package's sharded
    FlashStore): a drain every 4 batches, a read of the whole universe
    mid-stream (buffered, staged and merged entries) and after the final
    flush. Returns ``(mid, final)`` answers."""
    universe = np.arange(UNIVERSE, dtype=np.int64)
    mid = None
    for i, (toks, d) in enumerate(make_batches(deltas=True)):
        store.update(toks, d)
        if i % 4 == 3:
            store.drain(wait=True)
        if i == 9:
            store.quiesce()
            mid = np.asarray(store.query(universe))
    store.flush()
    return mid, np.asarray(store.query(universe))


def open_sharded(scheme: str, wal=None, **kw):
    """The port's 8-shard store on the CPU; in a worker its 4 local shards
    of the group. The threshold is moot with several processes (no
    auto-drain) and keeps the single-process store on the same explicit
    drain cadence."""
    from repro_torch.core import table_torch as tt
    from repro_torch.core.distributed import ShardedTableConfig
    from repro_torch.core.store import FlashStore
    cfg = ShardedTableConfig(local=tt.FlashTableConfig(**table_kwargs(scheme)),
                             num_shards=NUM_SHARDS, bucket_cap=BUCKET_CAP)
    kw.setdefault("shard_chunk", 256)
    kw.setdefault("flush_threshold", 1 << 30)
    return FlashStore.open(cfg, backend="sharded", device="cpu", wal=wal,
                           **kw)


def ingest(store, batches, mine=lambda i: True, drain_every: int = 4):
    """Every rank walks the global batch sequence, folds only its own
    batches and reaches every collective drain with the others."""
    for i, (toks, d) in enumerate(batches):
        if mine(i):
            store.update(toks, d)
        if i % drain_every == drain_every - 1:
            store.drain(wait=True)


def query_universe(store) -> np.ndarray:
    return np.asarray(store.query_batch(np.arange(UNIVERSE, dtype=np.int64)))


# ---------------------------------------------------------------------------
# roles
# ---------------------------------------------------------------------------
def run_worker(a) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{a.port}",
        world_size=NUM_PROCS, rank=a.pid,
        timeout=datetime.timedelta(seconds=CHILD_TIMEOUT))
    try:
        worker_scenario(a)
    finally:
        dist.destroy_process_group()
    print(f"MH{a.pid}_OK", flush=True)


def worker_scenario(a) -> None:
    tmp = Path(a.tmp)
    mine = lambda i: i % NUM_PROCS == a.pid
    if a.scenario == "equivalence":
        store = open_sharded(a.scheme)
        assert store._b.multihost and store._b.group.local_shards == (
            [0, 1, 2, 3] if a.pid == 0 else [4, 5, 6, 7])
        ingest(store, make_batches(deltas=True), mine)
        store.flush(wait=True)
        got = query_universe(store)
        s = store.stats()
        assert s["write_carried"] == 0, s     # no (src, dst) bucket overflows
        assert s["dropped"] == 0, s
        assert s["collectives"] == "gloo", s
        assert s["write_dispatches"] > 0, s
        np.save(tmp / f"mh_counts_{a.pid}.npy", got)
        store.close()
    elif a.scenario == "heat":
        store = open_sharded(a.scheme)
        # the whole trace lands on rank 0; rank 1 joins the collectives
        # with nothing sealed
        ingest(store, make_batches(seed=3), lambda i: a.pid == 0)
        store.flush(wait=True)
        heat = store.partition_heat(np.arange(UNIVERSE, dtype=np.int64))
        if a.pid == 0:
            np.save(tmp / "mh_heat_0.npy", np.asarray(heat))
        store.close()
    elif a.scenario == "wal_restore":
        wal_path = tmp / f"wal_{a.pid}.log"
        store = open_sharded(a.scheme, wal=str(wal_path))
        ingest(store, make_batches(seed=5), mine)
        store.drain(wait=True)
        # crash: abandon the store unclosed; the per-host WAL survives
        store._b._disp.close()
        store.wal.close()
        store2 = open_sharded(a.scheme, wal=str(wal_path))
        rep = store2.restore(path=None)
        assert rep.records_replayed > 0, rep
        store2.flush(wait=True)
        np.save(tmp / f"mh_counts_{a.pid}.npy", query_universe(store2))
        store2.close()
    elif a.scenario == "handoff":
        from repro_torch.runtime.elastic import handoff_hr_partitions
        store = open_sharded(a.scheme)
        ingest(store, make_batches(seed=7), mine)
        store.drain(wait=True)
        n_rec, n_ent = handoff_hr_partitions(str(tmp / "depart.log"), store)
        print(f"HANDOFF{a.pid} records={n_rec} entries={n_ent}", flush=True)
        assert n_rec > 0
        store.flush(wait=True)
        np.save(tmp / f"mh_counts_{a.pid}.npy", query_universe(store))
        store.close()
    else:
        raise SystemExit(f"unknown scenario {a.scenario}")


# ---------------------------------------------------------------------------
# parent: spawn, wait, compare
# ---------------------------------------------------------------------------
def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(a, port: int, pid: int) -> subprocess.Popen:
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--role", "worker",
           "--scenario", a.scenario, "--scheme", a.scheme, "--tmp", a.tmp,
           "--port", str(port), "--pid", str(pid)]
    return subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait_all(procs) -> list:
    """Every child's output; a child that fails or outlives the limit
    fails the run, and no child is left running."""
    outs = []
    try:
        for p, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=CHILD_TIMEOUT + 30)
            if proc.returncode != 0 or f"MH{p}_OK" not in out:
                raise AssertionError(f"worker {p} rc={proc.returncode}\n{out}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def single_process(a, batches) -> object:
    """The port's single-process 8-shard store after the same stream."""
    store = open_sharded(a.scheme)
    ingest(store, batches)
    store.flush(wait=True)
    return store


def run_parent(a) -> None:
    tmp = Path(a.tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    if a.scenario == "handoff":
        # the departing node: a WAL'd sim store, one sealed record a batch
        # (only its log matters), so both survivors get a non-empty slice
        from repro_torch.core.store import FlashStore
        dstore = FlashStore.open(backend="sim", scheme=a.scheme,
                                 wal=str(tmp / "depart.log"))
        for toks, d in make_batches(seed=11):
            dstore.update(toks, d)
            dstore.drain(wait=True)
        dstore.close()
    port = free_port()
    outs = _wait_all([_spawn(a, port, p) for p in range(NUM_PROCS)])
    if a.scenario == "handoff":
        print("".join(outs), flush=True)
    keys = np.arange(UNIVERSE, dtype=np.int64)
    if a.scenario == "heat":
        # rank 0 sealed the whole trace: its heat ledger is the
        # single-process store's, block for block
        got = np.load(tmp / "mh_heat_0.npy")
        store = single_process(a, make_batches(seed=3))
        one = store.partition_heat(keys)
        store.close()
        np.testing.assert_allclose(got, one, rtol=1e-12)
        assert one.max() > 0, "the skewed trace made no heat"
        assert int(np.argmax(got)) == int(np.argmax(one))
        print("HEAT_MATCH victim", int(np.argmax(one)), flush=True)
    else:
        got = [np.load(tmp / f"mh_counts_{p}.npy") for p in range(NUM_PROCS)]
        np.testing.assert_array_equal(got[0], got[1])
        seed = {"equivalence": 0, "wal_restore": 5, "handoff": 7}[a.scenario]
        batches = make_batches(seed=seed, deltas=a.scenario == "equivalence")
        want = truth_of(batches)
        if a.scenario == "handoff":
            want += truth_of(make_batches(seed=11))
        np.testing.assert_array_equal(got[0], want)
        if a.scenario == "equivalence":
            store = single_process(a, batches)
            np.testing.assert_array_equal(got[0], query_universe(store))
            store.close()
            from repro_torch.core.store import FlashStore
            sim = FlashStore.open(backend="sim", scheme=a.scheme)
            for toks, d in batches:
                sim.update(toks, d)
            sim.flush()
            np.testing.assert_array_equal(got[0], sim.query(keys))
            sim.close()
            np.save(tmp / "mh_counts.npy", got[0])
    print("MULTIHOST_OK", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="parent", choices=("parent", "worker"))
    ap.add_argument("--scenario", default="equivalence",
                    choices=("equivalence", "heat", "wal_restore", "handoff"))
    ap.add_argument("--scheme", default="MDB-L",
                    choices=("MB", "MDB", "MDB-L"))
    ap.add_argument("--tmp", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--pid", type=int, default=0)
    a = ap.parse_args()
    if a.role == "parent":
        run_parent(a)
    else:
        # a collective that never completes dumps every thread's stack
        # and exits non-zero instead of hanging the parent
        faulthandler.dump_traceback_later(CHILD_TIMEOUT, exit=True)
        run_worker(a)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main()
