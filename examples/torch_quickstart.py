"""Quickstart (PyTorch port): one `FlashStore`, three backends (the SSD
simulator on the host, the device table, the sharded table) — the same
API and the same deferred-update discipline (H_R buffer → block-local
merges) as the JAX package's ``examples/quickstart.py``.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the device and sharded tables run on the card by default)
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
import numpy as np

from repro_torch.core import FlashStore


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=200_000)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    tokens = (rng.zipf(1.4, size=args.tokens) % (1 << 20)).astype(np.int64)
    uniq, cnt = np.unique(tokens, return_counts=True)
    probe, truth = uniq[:512], dict(zip(uniq.tolist(), cnt.tolist()))
    for backend in ("sim", "device", "sharded"):
        kw = {} if backend == "sim" else {"device": args.device}
        with FlashStore.open(backend=backend, scheme="MDB-L", **kw) as store:
            store.update(tokens)                    # buffered + deduped in H_R
            store.increment(int(probe[0]), -1)      # deletion by decrement
            store.increment(int(probe[0]), +1)
            counts = store.query(probe)             # batched, read-your-writes
            ok = all(truth[int(k)] == int(c) for k, c in zip(probe, counts))
            store.flush()                           # durability point: merge
            s = store.stats()
            wear = s.get("tile_stores", s.get("cleans"))
            print(f"{backend:8s} 512 point queries correct: {ok}; "
                  f"wear (cleans analogue): {wear}")


if __name__ == "__main__":
    main()
