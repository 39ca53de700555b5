"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> --tiny``.

Greedy decoding with the flash-hash prefix KV cache (counting refcounts)
on one device: the card unless ``--device cpu`` is asked for. The weights
are drawn from ``--seed``. Prints per-request outputs + cache statistics.
``--backend sim`` keeps the cache's refcounts in the event-level
simulator on the host. ``--continuous`` is not ported yet and is refused.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_3b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="tokens shared across requests (exercises the "
                         "prefix cache)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler (not ported yet)")
    ap.add_argument("--backend", default="device",
                    choices=("device", "sim"),
                    help="refcount-table backend for the prefix cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card by default, 'cpu' for the "
                         "plain versions of the kernels")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.continuous:
        ap.error("--continuous is not ported yet (ROADMAP.md, Queue 1: "
                 "Continuous batching)")

    from ..configs import get_config
    from ..models.model import Model
    from ..serving import PrefixKVCache, Request, ServeEngine

    cfg = get_config(args.arch, tiny=args.tiny)
    model = Model(cfg, device=args.device, seed=args.seed)
    cache = PrefixKVCache(block_tokens=8, capacity_blocks=64,
                          backend=args.backend, device=args.device)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix).tolist()
    prompts = [shared + rng.integers(
        0, cfg.vocab_size,
        args.prompt_len - args.shared_prefix).tolist()
        for _ in range(args.requests)]

    t0 = time.time()
    engine = ServeEngine(cfg, model, prefix_cache=cache)
    done = engine.serve([Request(prompt=p, max_new_tokens=args.max_new)
                         for p in prompts])
    dt = time.time() - t0
    for i, r in enumerate(done):
        print(f"req{i}: cached={r.cached_tokens} out={r.output[:8]}...")
    tok = sum(len(r.output) for r in done)
    print(f"[serve:serial] {len(done)} requests, {tok} tokens in "
          f"{dt:.2f}s ({tok / max(dt, 1e-9):.1f} tok/s) on {model.device}")
    print(f"[prefix-cache] {cache.stats()}")
    cache.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
