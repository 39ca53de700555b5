"""Zipf-prompt trace generator over a simulated user population.

Serving traffic is skewed: a few "users" (agents, templates, tenants)
account for most requests, and each user's requests share a long system
prompt. Flashield (PAPERS.md) shows cache-admission and wear decisions
only become visible under such skewed streams, so the load harness
replays exactly that shape: users are drawn from a Zipf(s) distribution,
every request reuses its user's fixed system-prefix (block-aligned so the
paged prefix cache can share it bitwise) followed by a random per-request
suffix, and arrivals follow a Poisson process.

No threading here — replay lives in :mod:`.scheduler` (the one serving
file flashlint FL004 lets spawn workers). This is the reference's
numpy-only generator, kept as the port's own copy: the same seed gives
the same prompts, arrivals and users.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class TraceItem:
    prompt: List[int]
    max_new_tokens: int
    arrival_s: float
    user: int


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def make_trace(num_requests: int = 32, num_users: int = 8,
               zipf_s: float = 1.2, prefix_blocks: int = 2,
               block_tokens: int = 16, suffix_tokens: Tuple[int, int] = (4, 12),
               max_new_tokens: int = 8, vocab_size: int = 509,
               arrival_rate_hz: float = 50.0,
               seed: int = 0) -> List[TraceItem]:
    """Build a reproducible arrival-timed request trace.

    Each user owns a fixed system prefix of ``prefix_blocks`` whole cache
    blocks (``prefix_blocks * block_tokens`` tokens) — so two requests
    from the same user share that many block-aligned prefix tokens, and
    the expected prefix-cache token hit rate on replay is governed by the
    Zipf skew. Suffix lengths are uniform in ``suffix_tokens`` and
    deliberately *not* block-aligned.
    """
    rng = np.random.default_rng(seed)
    # token 0 is the scheduler's pad token — keep prompts clear of it so
    # traces can assert exact prompt roundtrips
    prefixes = rng.integers(1, vocab_size,
                            size=(num_users, prefix_blocks * block_tokens))
    users = rng.choice(num_users, size=num_requests,
                       p=_zipf_weights(num_users, zipf_s))
    gaps = rng.exponential(1.0 / arrival_rate_hz, size=num_requests)
    arrivals = np.cumsum(gaps)
    items = []
    for i in range(num_requests):
        u = int(users[i])
        nsuf = int(rng.integers(suffix_tokens[0], suffix_tokens[1] + 1))
        suffix = rng.integers(1, vocab_size, size=nsuf)
        items.append(TraceItem(
            prompt=[int(t) for t in prefixes[u]] + [int(t) for t in suffix],
            max_new_tokens=max_new_tokens,
            arrival_s=float(arrivals[i]),
            user=u))
    return items
