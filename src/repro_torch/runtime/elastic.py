"""Hand a departed store's sealed H_R chunks to the surviving stores.

When a node leaves, its store's sealed-but-undrained chunks are exactly
the records of its write-ahead log after its last snapshot.
:func:`handoff_hr_partitions` replays them into a surviving store, whose
own owner routing re-partitions every entry over the surviving shards.
With a survivor that spans several processes, every surviving process
calls it with the same log and replays a disjoint round-robin-by-seq
slice of the records, so each chunk lands exactly once.

The mesh re-planning of the training runtime (``plan_mesh_shape``,
``remesh_shardings``) comes with the training slice of the port.
"""
from __future__ import annotations

from typing import Tuple


def _survivor_processes(survivor) -> Tuple[int, int]:
    """``(process_index, num_processes)`` of the surviving store, from the
    store itself (its backend recorded its process group), *not* from
    the departing log's partition count, which says how the departed
    store split its H_R."""
    b = getattr(survivor, "_b", survivor)
    return (int(getattr(b, "process_index", 0)),
            int(getattr(b, "num_processes", 1)))


def handoff_hr_partitions(wal_path, survivor, shards=None,
                          base_seq: int = 0) -> Tuple[int, int]:
    """Re-own a departing store's sealed H_R partitions through its WAL.

    Replays every seal record after ``base_seq`` (the departed store's
    last snapshot) into ``survivor``'s H_R. ``shards`` keeps only the
    records of those H_R partitions (the log records the partition of
    every seal); ``None`` takes them all. With several surviving
    processes each replays records ``i`` with ``i % num_processes ==
    process_index`` (in seq order), so no chunk is applied twice; the
    next collective drain routes every entry to its owner.

    Returns ``(records_replayed, entries_replayed)`` for this process.
    The survivor's own WAL, if any, logs the re-owned chunks as new
    seals."""
    from ..core.wal import SEAL, read_wal
    records, _ = read_wal(wal_path)
    keep = None if shards is None else set(shards)
    me, n_procs = _survivor_processes(survivor)
    n_rec = n_ent = 0
    for i, r in enumerate(sorted(
            (r for r in records if r.kind == SEAL
             and r.seq > base_seq
             and (keep is None or r.part in keep)),
            key=lambda r: r.seq)):
        if i % n_procs != me:
            continue
        survivor.update(r.keys, r.deltas)
        n_rec += 1
        n_ent += int(r.keys.size)
    return n_rec, n_ent


__all__ = ["handoff_hr_partitions"]
