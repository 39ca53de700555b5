"""Runtime lock-discipline + happens-before harness.

The static rules (flashlint) prove the *code* takes the lock and pairs
rebinds with invalidations; this harness proves the *executions* do.
Attach a :class:`Tracer` to a live store and every contract-relevant
event — H_R seal/swap, drain dispatch, device-state rebind, cache
invalidate, lookup/insert — is recorded with a vector-clock timestamp.
:meth:`Tracer.check` then replays the log and reports interleavings no
serial execution could produce, turning the stress lane's "didn't crash
in 3 seeds" into "no unserializable interleaving observed".

Happens-before edges (the only orderings the checker trusts):

1. **program order** — events of one thread, in sequence;
2. **lock edges** — releasing the traced state lock publishes the
   holder's clock; the next acquirer merges it (release → acquire);
3. **submit/join edges** — ``FlushDispatcher.submit`` forks the
   caller's clock into the drain job (submit → job start) and
   ``wait()`` joins the finished job's clock back (job end → barrier
   return).

Two events *conflict* when they touch the same resource (``hr:active``,
``hr:inflight``, ``state``, ``cache`` — per shard where sharded) and at
least one writes. Three checks run over the log:

- **data-race** — conflicting events on different threads whose clocks
  are incomparable: neither happened before the other, so the
  interleaving was a coin flip (e.g. sealing H_R over a chunk the
  worker is still draining);
- **unfenced-rebind** — a drain job rebound the device state and
  reached its end without invalidating the paired query engine
  (skipped when the log has no invalidations at all: an engine with no
  cache has nothing to fence);
- **stale-cache-insert** — a cache insert whose captured epoch is
  smaller than the number of invalidations that happened-before it:
  the inserted count predates an invalidation yet outlived it.

The tracer records only accesses the contracts care about; deliberately
benign unlocked reads (``buffered_entries``, the pre-barrier poison
probe) are untraced, so a clean store yields a clean log. Everything
here is stdlib-only — no torch import.
"""
from __future__ import annotations

import dataclasses
# the harness instruments the dispatcher's lock and worker; it is an
# audited home for threading primitives (flashlint FL004 allows it)
import threading
from typing import Dict, List, Optional, Tuple

Clock = Dict[int, int]


@dataclasses.dataclass(frozen=True)
class Event:
    """One traced access, stamped with the recording thread's clock."""

    seq: int
    thread: int
    kind: str
    resource: Optional[str]
    rw: Optional[str]               # "r" / "w" / None (informational)
    clock: Tuple[Tuple[int, int], ...]  # frozen vector clock
    meta: Tuple[Tuple[str, object], ...]

    def get(self, key: str, default=None):
        return dict(self.meta).get(key, default)

    def describe(self) -> str:
        extra = "".join(f" {k}={v}" for k, v in self.meta)
        res = f" {self.resource}/{self.rw}" if self.resource else ""
        return f"#{self.seq} t{self.thread} {self.kind}{res}{extra}"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One detected contract violation in a recorded execution."""

    kind: str                       # data-race / unfenced-rebind /
                                    # stale-cache-insert
    message: str
    events: Tuple[Event, ...]

    def describe(self) -> str:
        lines = [f"[{self.kind}] {self.message}"]
        lines += [f"    {e.describe()}" for e in self.events]
        return "\n".join(lines)


def _leq(a: Clock, b: Clock) -> bool:
    return all(v <= b.get(t, 0) for t, v in a.items())


def _concurrent(a: Clock, b: Clock) -> bool:
    return not _leq(a, b) and not _leq(b, a)


class Tracer:
    """Vector-clock event recorder. Thread-safe; its internal mutex is
    *not* a happens-before edge (it orders appends, not the program)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._events: List[Event] = []
        self._clocks: Dict[int, Clock] = {}
        self._locks: Dict[str, Clock] = {}
        self._seq = 0

    # -- clock plumbing ------------------------------------------------
    def _own(self, tid: int) -> Clock:
        return self._clocks.setdefault(tid, {})

    def _tick(self, tid: int) -> None:
        c = self._own(tid)
        c[tid] = c.get(tid, 0) + 1

    def _merge(self, tid: int, snap: Clock) -> None:
        c = self._own(tid)
        for t, v in snap.items():
            if v > c.get(t, 0):
                c[t] = v

    # -- recording -----------------------------------------------------
    def record(self, kind: str, resource: Optional[str] = None,
               rw: Optional[str] = None, **meta) -> None:
        tid = threading.get_ident()
        with self._mu:
            self._tick(tid)
            self._events.append(Event(
                seq=self._seq, thread=tid, kind=kind, resource=resource,
                rw=rw, clock=tuple(sorted(self._own(tid).items())),
                meta=tuple(sorted(meta.items()))))
            self._seq += 1

    def fork(self) -> Clock:
        """Snapshot the calling thread's clock for handoff to a job the
        receiving thread will :meth:`join` (submit → job-start edge)."""
        tid = threading.get_ident()
        with self._mu:
            self._tick(tid)
            return dict(self._own(tid))

    def join(self, snap: Optional[Clock]) -> None:
        """Merge a forked snapshot into the calling thread's clock
        (job-end → barrier-return edge, and the job-start side)."""
        if snap is None:
            return
        tid = threading.get_ident()
        with self._mu:
            self._merge(tid, snap)
            self._tick(tid)

    def acquired(self, name: str) -> None:
        """Called *after* the real lock is held: merge the clock the last
        releaser published (release → acquire edge)."""
        tid = threading.get_ident()
        with self._mu:
            self._merge(tid, self._locks.get(name, {}))
            self._tick(tid)

    def released(self, name: str) -> None:
        """Called *before* the real lock is dropped: publish the holder's
        clock for the next acquirer."""
        tid = threading.get_ident()
        with self._mu:
            self._tick(tid)
            self._locks[name] = dict(self._own(tid))

    @property
    def events(self) -> List[Event]:
        with self._mu:
            return list(self._events)

    # -- the replay checker ---------------------------------------------
    def check(self) -> List[Finding]:
        """Replay the log; one :class:`Finding` per violated contract."""
        events = self.events
        out: List[Finding] = []
        out.extend(_check_unfenced_rebinds(events))
        out.extend(_check_data_races(events))
        out.extend(_check_stale_cache_inserts(events))
        return out


def _check_data_races(events: List[Event]) -> List[Finding]:
    touch = [e for e in events if e.resource is not None and e.rw]
    out: List[Finding] = []
    seen = set()
    for i, a in enumerate(touch):
        for b in touch[i + 1:]:
            if (a.resource != b.resource or a.thread == b.thread
                    or ("w" not in (a.rw, b.rw))):
                continue
            if not _concurrent(dict(a.clock), dict(b.clock)):
                continue
            sig = (a.resource, frozenset((a.kind, b.kind)))
            if sig in seen:
                continue            # one finding per (resource, kind pair)
            seen.add(sig)
            out.append(Finding(
                "data-race",
                f"unordered conflicting accesses to {a.resource}: "
                f"{a.kind} ({a.rw}) vs {b.kind} ({b.rw}) — no "
                "happens-before edge orders them",
                (a, b)))
    return out


def _check_unfenced_rebinds(events: List[Event]) -> List[Finding]:
    if not any(e.kind == "invalidate" for e in events):
        return []                   # no cache in play: nothing to fence
    out: List[Finding] = []
    open_rebinds: Dict[int, List[Event]] = {}
    for e in events:
        pend = open_rebinds.setdefault(e.thread, [])
        if e.kind == "state_rebind":
            pend.append(e)
        elif e.kind == "invalidate":
            pend.clear()            # fences every rebind before it
        elif e.kind == "job_end" and pend:
            for r in pend:
                out.append(Finding(
                    "unfenced-rebind",
                    "drain job rebound the device state and ended "
                    "without invalidating the paired query engine — "
                    "cached counts now describe a consumed state",
                    (r, e)))
            pend.clear()
    for pend in open_rebinds.values():   # rebinds never fenced at all
        for r in pend:
            out.append(Finding(
                "unfenced-rebind",
                "device-state rebind was never followed by a query-"
                "engine invalidation on its thread",
                (r,)))
    return out


def _check_stale_cache_inserts(events: List[Event]) -> List[Finding]:
    invals = [e for e in events if e.kind == "invalidate"]
    out: List[Finding] = []
    for e in events:
        if e.kind != "cache_insert":
            continue
        epoch = e.get("epoch")
        if epoch is None:
            continue
        ec = dict(e.clock)
        before = [iv for iv in invals if _leq(dict(iv.clock), ec)]
        if len(before) > int(epoch):
            out.append(Finding(
                "stale-cache-insert",
                f"cache insert fenced at epoch {epoch} but "
                f"{len(before)} invalidation(s) happened-before it — "
                "a count probed against a pre-drain state outlived the "
                "drain's invalidation",
                (before[-1], e)))
    return out


class TracedLock:
    """Wraps the dispatcher's state lock so every acquire/release becomes
    a happens-before edge in the trace. Re-entrant (delegates to the
    underlying RLock); redundant edge merges from nested acquires are
    harmless."""

    def __init__(self, inner, tracer: Tracer, name: str = "state-lock"):
        self._inner = inner
        self._tracer = tracer
        self._name = name

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            self._tracer.acquired(self._name)
        return got

    def release(self):
        self._tracer.released(self._name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def attach(store) -> Tracer:
    """Instrument a live store (a ``FlashStore`` or a bare backend):
    returns the :class:`Tracer` now wired into its dispatcher, lock and
    query engine. Attach *before* driving traffic; the checker assumes
    the log covers every epoch bump it is asked to reason about."""
    backend = getattr(store, "_b", store)
    disp = getattr(backend, "_disp", None) or getattr(
        backend, "dispatcher", None)
    if disp is None:
        raise ValueError(f"{type(backend).__name__} has no FlushDispatcher "
                         "to instrument")
    tracer = Tracer()
    disp.tracer = tracer
    disp.lock = TracedLock(disp.lock, tracer)
    qe = getattr(backend, "query_engine", None)
    if qe is not None:
        qe.tracer = tracer
    return tracer
