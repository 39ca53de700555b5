"""Fault-tolerant training runtime.

Failure modes covered:

* **Node loss / crash**: periodic asynchronous checkpoints with atomic
  publish (``checkpoint/``); :meth:`ResilientTrainer.run` restarts from
  the latest checkpoint and the stateless loader resumes from the step
  number.
* **Loss spikes / NaN**: :class:`NaNGuard` detects a non-finite or
  spiking loss; the trainer rolls back to the last checkpoint and *skips*
  the offending data window (the deterministic loader makes the skip
  reproducible).
* **Stragglers**: :class:`StepWatchdog` times each step against a
  rolling median; a slow step calls an alert callback.
* **Pre-emption**: an ``emergency()`` checkpoint on ``KeyboardInterrupt``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

from ..checkpoint import CheckpointManager, latest_step, restore_checkpoint


class StepWatchdog:
    """Detects straggling steps: wall time > factor × rolling median."""

    def __init__(self, factor: float = 3.0, window: int = 32,
                 min_samples: int = 5,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.stragglers: List[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        hist = sorted(self.times[-self.window:])
        is_slow = False
        if len(hist) >= self.min_samples:
            median = hist[len(hist) // 2]
            if seconds > self.factor * median:
                is_slow = True
                self.stragglers.append(step)
                if self.on_straggler:
                    self.on_straggler(step, seconds, median)
        self.times.append(seconds)
        return is_slow


class NaNGuard:
    """Rolls back on a non-finite or spiking loss."""

    def __init__(self, spike_factor: float = 10.0, window: int = 16):
        self.spike_factor = spike_factor
        self.window = window
        self.history: List[float] = []
        self.rollbacks = 0

    def check(self, loss: float) -> bool:
        """True = healthy; False = roll back."""
        if not math.isfinite(loss):
            self.rollbacks += 1
            return False
        hist = self.history[-self.window:]
        if len(hist) >= self.window // 2:
            mean = sum(hist) / len(hist)
            if loss > self.spike_factor * max(mean, 1e-6):
                self.rollbacks += 1
                return False
        self.history.append(loss)
        return True


@dataclasses.dataclass
class TrainerReport:
    steps_done: int = 0
    restarts: int = 0
    rollbacks: int = 0
    stragglers: int = 0
    final_loss: float = float("nan")


class ResilientTrainer:
    """Checkpointed, NaN-guarded, watchdogged train loop.

    ``step_fn(state, step) -> (state, metrics)`` where ``metrics["loss"]``
    converts to a float. ``state`` is any checkpoint tree (a dict of
    tensors, or the trainer's ``TrainState``, restored in place).
    ``stores`` (corpus statistics, prefix caches) get their ``quiesce``
    registered with the manager, so every checkpoint, the emergency one
    included, joins their in-flight drains first.
    """

    def __init__(self, step_fn, ckpt: CheckpointManager,
                 guard: Optional[NaNGuard] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 inject_failure_at: Optional[int] = None,
                 stores=()):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.guard = guard or NaNGuard()
        self.watchdog = watchdog or StepWatchdog()
        self.inject_failure_at = inject_failure_at  # for tests
        self._injected = False
        self.stores = tuple(stores)
        for s in self.stores:
            ckpt.register_quiesce(s.quiesce)

    def run(self, state, num_steps: int, start_step: int = 0) -> tuple:
        report = TrainerReport()
        step = start_step
        while step < num_steps:
            try:
                if (self.inject_failure_at is not None
                        and step == self.inject_failure_at
                        and not self._injected):
                    self._injected = True
                    raise RuntimeError("injected node failure")
                t0 = time.time()
                state, metrics = self.step_fn(state, step)
                loss = float(metrics["loss"])
                if self.watchdog.observe(step, time.time() - t0):
                    report.stragglers += 1
                if not self.guard.check(loss):
                    # roll back to the last checkpoint, skip this window
                    restored = self._restore(state)
                    if restored is not None:
                        state, _ = restored
                    report.rollbacks += 1
                    step += 1  # skip the poisoned batch
                    continue
                report.final_loss = loss
                self.ckpt.maybe_save(step, state)
                step += 1
                report.steps_done += 1
            except KeyboardInterrupt:
                self.ckpt.emergency(step, state)
                raise
            except RuntimeError:
                # node failure: no emergency save (the node is gone);
                # restart from the latest published checkpoint
                report.restarts += 1
                restored = self._restore(state)
                if restored is None:
                    raise
                state, meta = restored
                step = int(meta["step"]) + 1
        self.ckpt.wait()
        return state, report

    def _restore(self, like_state):
        self.ckpt.wait()              # an in-flight save publishes first
        if latest_step(self.ckpt.dir) is None:
            return None
        return restore_checkpoint(self.ckpt.dir, like_state)
