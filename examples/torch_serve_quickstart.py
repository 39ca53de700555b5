"""Serving quickstart (PyTorch port): continuous batching over the paged
prefix-KV block pool (flash-hash refcounts as the page table, on the sim
backend), driven by a tiny Zipf user trace; the twin of
``examples/serve_quickstart.py``.

Run: PYTHONPATH=src python examples/torch_serve_quickstart.py [--device cpu]
(the model runs on the card by default)
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving import (ContinuousBatchingScheduler, PrefixKVCache,
                                 make_trace, replay_trace)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                              dtype="float32")
    model = Model(cfg, device=args.device, seed=0)
    cache = PrefixKVCache(block_tokens=16, capacity_blocks=64, backend="sim")
    sched = ContinuousBatchingScheduler(cfg, model, prefix_cache=cache,
                                        max_slots=4, max_context=96)
    trace = make_trace(num_requests=args.requests, num_users=3,
                       prefix_blocks=2, max_new_tokens=8,
                       vocab_size=cfg.vocab_size, seed=0)
    report = replay_trace(sched, trace, workers=2)
    print(report.summary())
    s = cache.stats()
    print(f"blocks resident={s['resident']} pool_high_water="
          f"{s['pool_high_water']} refcount_evictions={s['evictions']}")
    cache.close()


if __name__ == "__main__":
    main()
