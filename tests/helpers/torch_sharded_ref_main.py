"""The reference's side of the sharded parity tests: the JAX package's
sharded FlashStore on 8 virtual CPU devices (one shard each).

    python torch_sharded_ref_main.py dump OUT
        For MB, MDB and MDB-L: the parity stream (``parity_run`` of
        ``torch_multihost_main``) through the reference's store, then
        ``OUT/<scheme>.npz`` (the global state's arrays under the
        checkpoint names, ``answers/mid`` and ``answers/final``),
        ``OUT/<scheme>.json`` (``stats()``) and a snapshot under
        ``OUT/snap_<scheme>``.
    python torch_sharded_ref_main.py restore SNAP OUT
        For each scheme: restore ``SNAP/<scheme>`` (a snapshot the port
        wrote) into a fresh reference store, then ``OUT/restored_<scheme>
        .npz`` (its global state and its answers over the universe).

This file is the reference side and imports JAX and the reference
package; the port's side (``torch_multihost_main``) imports neither.
"""
import os

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1] / "src"))
sys.path.insert(0, str(HERE))

import jax
import numpy as np

from repro.core import table_jax as tj
from repro.core.distributed import ShardedTableConfig
from repro.core.store import FlashStore
from torch_multihost_main import (BUCKET_CAP, NUM_SHARDS, PARITY, UNIVERSE,
                                  parity_run, table_kwargs)

SCHEMES = ("MB", "MDB", "MDB-L")


def open_ref(scheme: str) -> FlashStore:
    cfg = ShardedTableConfig(local=tj.FlashTableConfig(**table_kwargs(scheme)),
                             num_shards=NUM_SHARDS, bucket_cap=BUCKET_CAP)
    return FlashStore.open(cfg, backend="sharded", **PARITY)


def state_arrays(store) -> dict:
    """The global state as numpy under the checkpoint's names."""
    st = jax.tree.map(np.asarray, store.state)
    out = {f: getattr(st, f) for f in st._fields if f != "stats"}
    out.update({f"stats/{f}": getattr(st.stats, f) for f in st.stats._fields})
    return out


def dump(out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for scheme in SCHEMES:
        store = open_ref(scheme)
        mid, final = parity_run(store)
        stats = {k: v for k, v in store.stats().items()
                 if isinstance(v, (int, str))}
        np.savez(out / f"{scheme}.npz", **state_arrays(store),
                 **{"answers/mid": mid, "answers/final": final})
        (out / f"{scheme}.json").write_text(json.dumps(stats))
        store.snapshot(out / f"snap_{scheme}")
        store.close()


def restore(snap: Path, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for scheme in SCHEMES:
        store = open_ref(scheme)
        store.restore(snap / scheme)
        got = np.asarray(store.query(np.arange(UNIVERSE, dtype=np.int64)))
        np.savez(out / f"restored_{scheme}.npz", **state_arrays(store),
                 answers=got)
        store.close()


def main() -> None:
    assert jax.device_count() == NUM_SHARDS, jax.devices()
    if sys.argv[1] == "dump":
        dump(Path(sys.argv[2]))
    elif sys.argv[1] == "restore":
        restore(Path(sys.argv[2]), Path(sys.argv[3]))
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]}")
    print("REF_SHARDED_OK", flush=True)


if __name__ == "__main__":
    main()
