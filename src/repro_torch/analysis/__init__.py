"""Correctness tooling for the FlashStore concurrency contracts.

Two halves:

- :mod:`.flashlint` — AST-based static checker; named rules FL001–FL006
  enforce engine-pairing, in-place consumption, flush→invalidate,
  threading, shim, and lock-discipline contracts. CLI:
  ``python -m repro_torch.analysis.flashlint src/repro_torch chip_smoke.py
  tests``.
- :mod:`.race_harness` — opt-in runtime instrumentation: a vector-clock
  tracer attached to a live store records seal/swap/drain/invalidate/
  lookup events, and a replay checker flags unordered conflicting
  accesses to the H_R buffers and the hot cache.

Nothing here imports torch; the package is stdlib-only and safe to use
in lint-only CI jobs without an accelerator stack.
"""
from __future__ import annotations

__all__ = ["flashlint", "race_harness"]
