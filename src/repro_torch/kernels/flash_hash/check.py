"""Hold each flash-hash kernel against its plain version on the same inputs.

Used by ``chip_smoke.py`` at the main path's shapes and by the GPU tests
at smaller ones. Every case is made from a seed on the target device:
a table filled through the plain merge to a given load, then update rows
(hits, inserts and overfull rows that spill) or query layouts. Two
query layouts: the dense :func:`query_layout` (every lane of every row
live: held keys, absent keys, 1/16 EMPTY) and :func:`path_query_layout`,
the very ``(blocks, q2)`` the lookup path hands the kernels for one
dispatch (one row per queried block, a key or two a row, the rest EMPTY
padding). Each ``check_*`` runs the wrapper (the CUDA kernel for CUDA
tensors) and the plain version from identical copies of the inputs, and
returns the largest absolute difference over every output, every lane
included (0 is required: the results are integers), the times of both,
and the least time the card could take for the same work.

That least time (``bound_ms``) is the larger of two: the bytes these
inputs need moved, over the card's memory rate, and the operations they
need, over its scalar rate. Bytes are counted in 32-byte sectors, the
least the memory system moves: a probe needs only the sectors of its
window of slots (home to the slot it stops at, the windows of one tile
merged), a hit only the sector of its count, a Bloom test only the
sectors of the words it tests. Inputs that are read whole (key and
update rows, block ids) and every output count in full. Operations are
one compare per slot a probe walks, and a few per Bloom test.

Times on the card, every one a median over ``reps`` turns:

* ``device_ms``: the kernel's own device time per launch, with no Python
  between launches (:func:`device_ms`: ``CALLS_PER_TURN`` raw launches
  captured in a CUDA graph, its replays timed between two CUDA events).
  The query kernel takes it cold (:data:`L2_FLUSH_BYTES` written before
  every launch, evicting the L2, as the path's random tiles arrive) and
  warm (``warm_device_ms``), the Bloom probe warm; the kernels the merge
  and the query replaced beside them (``serial_device_ms``,
  ``staged_device_ms``), and for the Bloom probe a floor,
  ``copy_device_ms``: ``may.copy_(q2)``, the same lane bytes in and out
  with nothing computed.
* ``ms``: the same raw launches from Python, ``CALLS_PER_TURN`` between
  two events (:func:`in_turns`); for a kernel shorter than its launch
  this is the host's launch rate, and ``ms`` - ``device_ms`` is that
  launch cost.
* ``wrapper_ms``: the wrapper with its checks and their host sync.

Each call of a turn takes its own inputs where the kernel would
otherwise find them in the L2: a merge updates its table in place, so
each call works on its own copy, restored before the turn, outside the
timed region; the lookup checks rotate over ``CALLS_PER_TURN`` layouts.
The plain version (``plain_ms``) is timed over single calls
(:func:`time_ms`). On the CPU ``ms`` and ``plain_ms`` are host-clock
times of the plain version and name no device; :func:`device_ms` raises.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ...core.hashing import (Pow2Hash, bloom_positions, filter_bits_log2,
                             filter_words_for)
from . import kernel as K
from . import ops, ref

EMPTY = ref.EMPTY
#: published HBM3 bandwidth of an H100 SXM (bytes/s) — the bytes bound
H100_BYTES_PER_S = 3.35e12
#: published float32 rate of an H100 SXM outside the tensor cores (op/s),
#: taken for the scalar int32 compares of the probes
H100_SCALAR_OPS_PER_S = 67e12
#: bytes of one sector, the least the memory system moves at a time
SECTOR = 32
_WORDS = SECTOR // 4
_I32 = torch.int32


#: calls of one function between two events in :func:`in_turns`, and
#: launches captured in one graph by :func:`device_ms`
CALLS_PER_TURN = 10
#: bytes written before every launch of a cold :func:`device_ms`: twice
#: the H100's 50 MB L2
L2_FLUSH_BYTES = 100 << 20


def time_ms(fn: Callable[[], object], reps: int,
            before: Optional[Callable[[], None]] = None,
            device: Optional[torch.device] = None) -> float:
    """Median milliseconds of single calls of ``fn()`` over ``reps`` calls
    (after one warm-up call); ``before()`` runs untimed ahead of every
    call. CUDA events on the card, the host clock elsewhere."""
    cuda = device is not None and device.type == "cuda"
    out = []
    for i in range(reps + 1):
        if before is not None:
            before()
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        if i:
            out.append(ms)
    return statistics.median(out)


def in_turns(fns: Dict[str, Callable[[int], object]], reps: int, device,
             before: Optional[Callable[[], None]] = None
             ) -> Dict[str, float]:
    """Median CUDA-event milliseconds per call of each function, timed in
    turns: each round runs every function ``CALLS_PER_TURN`` times back to
    back between two events (``fn(i)`` for the turn's ``i``-th call),
    after one warm-up round; ``before()`` runs untimed ahead of every
    turn. The host issues each call while the device runs the last, so a
    call shorter than its launch is timed at the host's launch rate:
    :func:`device_ms` gives the device's own time."""
    times = {name: [] for name in fns}
    for i in range(reps + 1):
        for name, fn in fns.items():
            if before is not None:
                before()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for call in range(CALLS_PER_TURN):
                fn(call)
            b.record()
            torch.cuda.synchronize(device)
            if i:
                times[name].append(a.elapsed_time(b) / CALLS_PER_TURN)
    return {name: statistics.median(t) for name, t in times.items()}


def _need_cuda(device, what: str) -> torch.device:
    device = torch.device(device) if device is not None else None
    if (device is None or device.type != "cuda"
            or not torch.cuda.is_available()):
        raise RuntimeError(f"{what} times CUDA launches on a CUDA device, "
                           f"got {device}")
    return device


def device_ms(fns: Dict[str, Callable[[int], object]], reps: int, device,
              flush_bytes: int = 0,
              before: Optional[Callable[[], None]] = None
              ) -> Dict[str, float]:
    """Device milliseconds per call of each function, with no Python
    between calls: ``fn(0) .. fn(CALLS_PER_TURN - 1)`` run once eagerly
    (libraries load, scratch is allocated), then are captured in one CUDA
    graph, whose replays are timed between two CUDA events in turns over
    ``reps`` rounds after a warm-up round; ``before()`` runs untimed ahead
    of every replay. With ``flush_bytes``, a write of that many bytes
    precedes every call in the graph, so that each call finds the L2
    holding other data; a graph of the writes alone is replayed in the
    same turns, and each round's time of it is subtracted. Without a
    flush the medians include each launch's gap on the stream; behind a
    flush most of it hides in the write before. Raises without CUDA."""
    device = _need_cuda(device, "device_ms")
    scratch = (torch.empty(flush_bytes // 4, dtype=_I32, device=device)
               if flush_bytes else None)

    def calls(fn):
        def run():
            for i in range(CALLS_PER_TURN):
                if scratch is not None:
                    scratch.fill_(i)
                if fn is not None:
                    fn(i)
        return run

    runs = {name: calls(fn) for name, fn in fns.items()}
    if scratch is not None:
        runs[None] = calls(None)
    graphs = {}
    for name, run in runs.items():
        if before is not None:
            before()
        run()
        torch.cuda.synchronize(device)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], capture_error_mode="relaxed"):
            run()
    times = {name: [] for name in graphs}
    for i in range(reps + 1):
        for name, graph in graphs.items():
            if before is not None:
                before()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize(device)
            if i:
                times[name].append(a.elapsed_time(b) / CALLS_PER_TURN)
    base = times.pop(None, None) or [0.0] * reps
    del graphs
    return {name: statistics.median(t - f for t, f in zip(ts, base))
            for name, ts in times.items()}


def profiled_ms(fns: Dict[str, Callable[[int], object]],
                kernels: Dict[str, str], reps: int, device,
                flush_bytes: int = 0) -> Dict[str, Optional[float]]:
    """Mean device duration of one kernel per function, from a
    ``torch.profiler`` (CUPTI) trace of ``reps`` eager turns of
    ``fn(0) .. fn(CALLS_PER_TURN - 1)``, with the same L2 flush as
    :func:`device_ms`: ``kernels[name]`` is a piece of the name of the
    kernel ``fns[name]`` launches. The kernels' own start-to-end times,
    without launch gaps: the cross-check of :func:`device_ms`. ``None``
    where the trace holds no such kernel. Raises without CUDA."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    device = _need_cuda(device, "profiled_ms")
    scratch = (torch.empty(flush_bytes // 4, dtype=_I32, device=device)
               if flush_bytes else None)
    for fn in fns.values():
        fn(0)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in fns.values():
                for i in range(CALLS_PER_TURN):
                    if scratch is not None:
                        scratch.fill_(i)
                    fn(i)
        torch.cuda.synchronize(device)
    out = {}
    for name, piece in kernels.items():
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and piece in e.name]
        out[name] = statistics.fmean(us) / 1e3 if us else None
    return out


def _counted(fn: Callable[[], Dict]) -> Dict:
    """``fn()`` with the launch counters as they were before it: the
    checks' launches are not the paths'."""
    saved = dict(K.LAUNCHES), dict(K.BASELINE_LAUNCHES)
    try:
        return fn()
    finally:
        K.LAUNCHES.update(saved[0])
        K.BASELINE_LAUNCHES.update(saved[1])


def _shares(out: Dict) -> Dict:
    """Each measured time's share of the bound (``device_ms`` gives
    ``device_bound_share``)."""
    for key in [k for k in out if k.endswith("ms")]:
        if key not in ("bound_ms", "plain_ms") and out[key]:
            out[key[:-2] + "bound_share"] = out["bound_ms"] / out[key]
    return out


def bound(n_bytes: int, n_ops: int) -> Dict:
    """The least time for ``n_bytes`` moved and ``n_ops`` scalar
    operations, and which of the two bounds it."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_bytes": n_bytes,
            "bound_ops": n_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def window_sectors(home, dist, r: int) -> torch.Tensor:
    """``(n, r // 8)`` bool: the sectors of an ``r``-slot int32 row that
    the cyclic windows ``[home, home + dist)`` of each row's lanes cover
    (``home``, ``dist``: ``(n, L)``; a lane with ``dist == 0`` covers
    nothing)."""
    n_s = max(r // _WORDS, 1)
    home, dist = home.long(), dist.long()
    live = (dist > 0).to(_I32)
    lo = home // _WORDS
    hi = torch.where(dist > 0, (home + dist - 1) // _WORDS + 1, lo)
    diff = torch.zeros((home.shape[0], 2 * n_s + 1), dtype=_I32,
                       device=home.device)
    diff.scatter_add_(1, lo, live)
    diff.scatter_add_(1, hi, -live)
    cov = diff.cumsum(1)[:, :2 * n_s] > 0
    return cov[:, :n_s] | cov[:, n_s:]


def word_sectors(words, live, n_words: int) -> torch.Tensor:
    """``(n, ceil(n_words / 8))`` bool: the sectors holding the words
    ``words[i, j]`` of row ``i`` where ``live[i, j]``."""
    n_s = -(-n_words // _WORDS)
    out = torch.zeros((words.shape[0], n_s), dtype=_I32, device=words.device)
    out.scatter_add_(1, torch.where(live, words.long() // _WORDS, 0),
                     live.to(_I32))
    return out > 0


def lane_sectors(live) -> torch.Tensor:
    """Sectors holding the words where ``live`` (an ``(n, W)`` mask)."""
    cols = torch.arange(live.shape[1], device=live.device).expand_as(live)
    return word_sectors(cols, live, live.shape[1])


def _per_block(mask, blocks, n_b: int) -> int:
    """Sectors of ``mask`` (one row per grid row), rows of one block
    merged."""
    acc = torch.zeros((n_b, mask.shape[1]), dtype=_I32, device=mask.device)
    acc.index_add_(0, blocks.long(), mask.to(_I32))
    return int((acc > 0).sum())


def _max_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def random_keys(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 1 << 30, (n,), generator=gen, dtype=torch.int64,
                         device="cpu").to(device=device, dtype=_I32)


def fill_table(pair: Pow2Hash, load: float, seed: int, device):
    """A table at ``load`` built through the plain merge (independent of
    the kernel): ``(keys, counts, filter_words)``."""
    n_b, r = pair.num_slots, pair.r
    gen = torch.Generator().manual_seed(seed)
    keys = torch.full((n_b, r), EMPTY, dtype=_I32, device=device)
    counts = torch.zeros((n_b, r), dtype=_I32, device=device)
    filt = torch.zeros((n_b, filter_words_for(r)), dtype=_I32, device=device)
    toks = random_keys(int(load * pair.q), gen, device)
    uk, uc, _, _, _ = ops.bucket_updates(pair, toks, torch.ones_like(toks), r)
    ids = torch.arange(n_b, dtype=_I32, device=device)
    ref.merge_dirty_plain(pair, keys, counts, filt, ids, uk, uc)
    return keys, counts, filt


def full_table(pair: Pow2Hash, seed: int, device):
    """A table whose every tile is full: ``r`` distinct keys of each block
    merged into empty tiles through the plain merge."""
    n_b, r = pair.num_slots, pair.r
    gen = torch.Generator().manual_seed(seed)
    keys = torch.full((n_b, r), EMPTY, dtype=_I32, device=device)
    counts = torch.zeros((n_b, r), dtype=_I32, device=device)
    filt = torch.zeros((n_b, filter_words_for(r)), dtype=_I32, device=device)
    uniq, cnt = ops.accumulate(random_keys(4 * pair.q, gen, device))
    uk, uc, _, _, _ = ops.bucket_updates(pair, uniq, cnt, r)
    ids = torch.arange(n_b, dtype=_I32, device=device)
    ref.merge_dirty_plain(pair, keys, counts, filt, ids, uk, uc)
    if bool((keys == EMPTY).any()):
        raise RuntimeError("full_table left a slot free")
    return keys, counts, filt


def merge_case(pair: Pow2Hash, keys, n_d: int, max_u: int, avg_u: int,
               hot_rows: int, seed: int, identity: bool = False):
    """Update rows for ``n_d`` listed blocks (a shuffled subset, or every
    block in order with ``identity``): about ``avg_u`` updates a row, a
    quarter of them hits on keys the tile holds, and ``hot_rows`` rows
    full to ``max_u`` with new keys (they spill once the tile fills)."""
    n_b, r = pair.num_slots, pair.r
    dev = keys.device
    gen = torch.Generator().manual_seed(seed)
    blocks = (torch.arange(n_b) if identity
              else torch.randperm(n_b, generator=gen)[:n_d]).to(dev, _I32)
    toks = random_keys(2 * n_b * max_u, gen, dev)
    new_k, _, _, _, _ = ops.bucket_updates(pair, toks, torch.ones_like(toks),
                                           max_u)
    new_k = new_k[blocks.long()]
    lens = torch.randint(0, 2 * avg_u + 1, (n_d,), generator=gen).to(dev)
    lens[:hot_rows] = max_u
    col = torch.arange(max_u, device=dev)
    uk = torch.where(col[None, :] < lens[:, None], new_k, EMPTY)
    slots = torch.randint(0, r, (n_d, max_u), generator=gen).to(dev)
    held = torch.gather(keys[blocks.long()], 1, slots)
    hit = ((col % 4 == 0)[None, :] & (held != EMPTY)
           & (col[None, :] < lens[:, None]))
    hit[:hot_rows] = False
    uk = torch.where(hit, held, uk).contiguous()
    uc = torch.randint(1, 6, (n_d, max_u), generator=gen, dtype=_I32).to(dev)
    uc = torch.where(uk != EMPTY, uc, 0).contiguous()
    return blocks, uk, uc


def check_merge_dirty(pair: Pow2Hash, table, blocks, uk, uc, reps: int = 3,
                      identity: bool = False) -> Dict:
    """Kernel (``merge_dirty``, or ``merge`` with ``identity``) against
    ``merge_dirty_plain`` on copies of one table; on the card also the
    serial kernel, held to the plain version (``serial_max_abs_err``) and
    timed in turns with the kernel and the wrapper."""
    dev = table[0].device
    work = [t.clone() for t in table]

    def restore(copy=work):
        for w, t in zip(copy, table):
            w.copy_(t)

    def run_wrapper(copy=work):
        keys_w, counts_w, filter_w = copy
        if identity:
            return K.merge(pair, keys_w, counts_w, filter_words=filter_w,
                           upd_keys=uk, upd_counts=uc)
        return K.merge_dirty(pair, keys_w, counts_w,
                             filter_words=filter_w,
                             dirty_blocks=blocks, upd_keys=uk, upd_counts=uc)

    def run_plain():
        keys_w, counts_w, filter_w = work
        return ref.merge_dirty_plain(pair, keys_w, counts_w,
                                     filter_words=filter_w,
                                     dirty_blocks=blocks, upd_keys=uk,
                                     upd_counts=uc)

    def run() -> Dict:
        restore()
        got = [t.clone() for t in run_wrapper()]
        restore()
        want = [t.clone() for t in run_plain()]
        out = {"max_abs_err": _max_err(got, want),
               "spills": int((want[3] != EMPTY).sum()),
               **merge_bound(pair, table, want[:3], blocks, uk)}
        if dev.type != "cuda":
            out["ms"] = time_ms(run_wrapper, reps, restore, dev)
            out["plain_ms"] = time_ms(run_plain, reps, restore, dev)
            return out
        ids = (torch.arange(pair.num_slots, dtype=_I32, device=dev)
               if identity else blocks)
        res = merge_in_turns(pair, table, ids, uk, uc, reps, run_wrapper)
        out["serial_max_abs_err"] = _max_err(res.pop("serial_out"), want)
        res.pop("per_row_out")
        out.update(res)
        out["plain_ms"] = time_ms(run_plain, reps, restore, dev)
        return out

    return _shares(_counted(run))


def merge_in_turns(pair: Pow2Hash, table, ids, uk, uc, reps: int,
                   wrapper: Optional[Callable[[list], object]] = None
                   ) -> Dict:
    """Kernel-only CUDA-event times of the merge of ``uk``/``uc`` into
    blocks ``ids`` of ``table`` (checked CUDA tensors), in turns: the
    parallel fold (``ms``), the serial kernel (``serial_ms``) and, if
    given, ``wrapper(copy)`` (``wrapper_ms``); both kernels' device times
    (``device_ms``, ``serial_device_ms``; :func:`device_ms`). Each call of
    a turn works on its own copy of the table, restored before the turn
    (before each graph replay), outside the timed region. ``per_row_out``
    and ``serial_out`` are each kernel's outputs (keys, counts, filter
    words, spill keys and counts) from one untimed call on the table as
    given. The launches are counted as
    usual; callers restore the counters (:func:`_counted`)."""
    spill = [torch.empty_like(uk), torch.empty_like(uc)]
    copies = [[t.clone() for t in table] for _ in range(CALLS_PER_TURN)]

    def restore_all():
        for copy in copies:
            for w, t in zip(copy, table):
                w.copy_(t)

    def launch(variant):
        return lambda i: K._launch_merge_dirty(
            pair, *copies[i], ids, uk, uc, *spill, variant)

    out = {}
    for variant in K.MERGE_ENTRIES:
        restore_all()
        launch(variant)(0)
        out[f"{variant}_out"] = [t.clone() for t in copies[0] + spill]
    fns = {"ms": launch("per_row"), "serial_ms": launch("serial")}
    if wrapper is not None:
        fns["wrapper_ms"] = lambda i: wrapper(copies[i])
    out.update(in_turns(fns, reps, uk.device, restore_all))
    out.update(device_ms({"device_ms": launch("per_row"),
                          "serial_device_ms": launch("serial")}, reps,
                         uk.device, before=restore_all))
    return out


def merge_bound(pair: Pow2Hash, before, after, blocks, uk) -> Dict:
    """What a merge of update rows ``uk`` into ``blocks`` must move and
    compute, given the table ``before`` and ``after`` it.

    Slots are never freed, so the slot a key took (or already held) lies
    in the merged tile, and every slot between its home and that slot was
    taken when it was probed: its probe window is home to that slot. A
    key absent from the merged tile spilled after walking all ``r``
    slots. Read: the keys' windows, the counts and filter words they
    touch, the update keys, the counts of valid updates, the block ids.
    Written: the key, count and filter sectors that changed, and both
    spill arrays in full."""
    n_d, max_u = uk.shape
    r, fw = pair.r, before[2].shape[1]
    b = blocks.long()
    valid = uk != EMPTY
    # the slot of every valid update in its merged tile, by sorted search
    # of (row, key) pairs
    row = torch.arange(n_d, device=uk.device)[:, None] << 32
    tile = (row + (after[0][b].long() & 0xFFFFFFFF)).reshape(-1)
    srt, order = torch.sort(tile)
    want = (row + (uk.long() & 0xFFFFFFFF)).reshape(-1)
    pos = torch.searchsorted(srt, want).clamp(max=max(srt.numel() - 1, 0))
    held = valid & (srt[pos] == want).reshape(n_d, max_u)
    slot = (order[pos] % r).reshape(n_d, max_u)
    home = pair.home_within_block(uk)
    dist = torch.where(held, ((slot - home) & (r - 1)) + 1,
                       torch.where(valid, r, 0))
    bits = bloom_positions(uk, filter_bits_log2(fw))
    filt_read = (word_sectors(bits[0] >> 5, valid, fw)
                 | word_sectors(bits[1] >> 5, valid, fw))
    sectors = (int(window_sectors(home, dist, r).sum())
               + int(word_sectors(slot, held, r).sum())
               + int(filt_read.sum())
               + sum(int(lane_sectors(x[b] != y[b]).sum())
                     for x, y in zip(before, after))
               + int(lane_sectors(valid).sum()))
    n_bytes = SECTOR * sectors + 4 * (n_d + n_d * max_u + 2 * n_d * max_u)
    n_ops = int(dist.sum()) + 6 * int(valid.sum())
    return bound(n_bytes, n_ops)


def query_layout(pair: Pow2Hash, keys, n_rows: int, qcap: int, seed: int,
                 part: int = 0):
    """``n_rows`` distinct blocks, each row's lanes a mix of keys its tile
    holds, absent keys of that block, and EMPTY padding (1/16). Parts
    ``0, 1, ...`` of one seed take consecutive runs of one permutation of
    the blocks: disjoint while ``n_rows * parts`` blocks last."""
    n_b, r = pair.num_slots, pair.r
    dev = keys.device
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_b, generator=gen)
    blocks = torch.roll(perm, -part * n_rows)[:n_rows].to(dev, _I32)
    toks = random_keys(2 * n_b * qcap, gen, dev) | (1 << 30)  # never stored
    absent, _, _, _, _ = ops.bucket_updates(pair, toks, torch.ones_like(toks),
                                            qcap)
    q2 = absent[blocks.long()]
    slots = torch.randint(0, r, (n_rows, qcap), generator=gen).to(dev)
    held = torch.gather(keys[blocks.long()], 1, slots)
    col = torch.arange(qcap, device=dev)[None, :]
    q2 = torch.where((col % 2 == 0) & (held != EMPTY), held, q2)
    q2 = torch.where(col % 16 == 15, EMPTY, q2)
    return blocks, q2.contiguous()


def lookup_mix(keys, seed: int, n_keys: int = 1024):
    """``chip_smoke.py``'s lookup mix as the query engine dedups it: a
    seeded draw of ``n_keys`` keys the table ``keys`` holds and ``n_keys``
    absent ones (at or above 2**30, where :func:`fill_table` stores none),
    sorted and unique (``np.unique``). Held keys sort first, so once the
    Bloom pre-filter has dropped most absent keys, a full chunk holds held
    keys alone, as every full chunk of the smoke's lookup does."""
    gen = torch.Generator().manual_seed(seed)
    held = keys[keys != EMPTY]
    pick = torch.randperm(held.numel(), generator=gen)[:n_keys]
    absent = random_keys(n_keys, gen, keys.device) | (1 << 30)
    return torch.unique(torch.cat([held[pick.to(keys.device)], absent]))


def padded(keys, n: int):
    """The query engine's dispatch chunk: the first ``n`` of ``keys``,
    EMPTY-padded to ``n``."""
    chunk = torch.full((n,), EMPTY, dtype=_I32, device=keys.device)
    chunk[:min(n, keys.numel())] = keys[:n]
    return chunk


def path_query_layout(pair: Pow2Hash, filter_words, chunk, qcap: int = 128):
    """What ``ops.query_blocked_ex`` launches for one dispatch chunk of the
    query engine (its Bloom pre-filter already applied): ``((blocks, q2)``
    of ``filter_probe_grid``, ``(blocks, q2)`` of ``query_grid)``, from
    ``ops.lookup_waves``. Raises unless each kernel gets one wave."""
    probed, _, _, waves = ops.lookup_waves(pair, chunk, pair.num_slots,
                                           qcap, filter_words)
    queried = [layout for _, _, layout in waves]
    if len(probed) != 1 or len(queried) != 1:
        raise ValueError(f"{len(probed)} Bloom and {len(queried)} query "
                         "waves: the chunk must fill one wave of each")
    return probed[0], queried[0]


def _lanes_of_block(pair, blocks, q2):
    """Gathered lanes: keys that belong to their row's block."""
    return (pair.s(q2) == blocks[:, None]) & (q2 != EMPTY)


def query_bound(pair: Pow2Hash, keys, blocks, q2, dists) -> Dict:
    """What ``query_grid`` must move and compute for its gathered lanes,
    given the distances it answered: each lane reads the key sectors of
    its window (home to the slot it stops at) and, on a hit, the count
    sector of that slot; the block ids and queries are read and both
    outputs written in full."""
    n_rows, qcap = q2.shape
    r = pair.r
    lanes = _lanes_of_block(pair, blocks, q2)
    dist = torch.where(lanes, dists, 0)
    home = pair.home_within_block(q2)
    slot = (home + dist - 1) & (r - 1)
    hit = lanes & (torch.gather(keys[blocks.long()], 1, slot.long()) == q2)
    sectors = (_per_block(window_sectors(home, dist, r), blocks,
                          pair.num_slots)
               + _per_block(word_sectors(slot, hit, r), blocks,
                            pair.num_slots))
    n_bytes = SECTOR * sectors + 4 * (n_rows + 3 * n_rows * qcap)
    return bound(n_bytes, int(dist.sum()))


def _mean_bound(bounds) -> Dict:
    """The bound of one call of a rotation: its layouts' mean bytes and
    operations."""
    n = len(bounds)
    return bound(sum(b["bound_bytes"] for b in bounds) / n,
                 sum(b["bound_ops"] for b in bounds) / n)


Layout = Tuple[torch.Tensor, torch.Tensor]


def check_query_grid(pair: Pow2Hash, table, blocks, q2, reps: int = 5,
                     rotation: Sequence[Layout] = ()) -> Dict:
    """``query_grid`` against ``query_grid_plain`` on every lane of the
    layout ``(blocks, q2)`` and of each of ``rotation``'s; on the card
    also the staged kernel (``staged_max_abs_err``). Call ``i`` of a turn
    takes layout ``i`` of the list; the bound is one call's mean. Device
    times cold and warm (module docstring)."""
    keys, counts, _ = table
    dev = keys.device
    layouts = [(blocks, q2), *rotation]
    at = lambda i: layouts[i % len(layouts)]
    outs = [(torch.empty_like(q), torch.empty_like(q)) for _, q in layouts]

    def launch(variant):
        return lambda i: K._launch_query_grid(
            pair, keys, counts, *at(i), *outs[i % len(layouts)], variant)

    def run() -> Dict:
        want = [ref.query_grid_plain(pair, keys, counts, b, q)
                for b, q in layouts]
        got = [K.query_grid(pair, keys, counts, b, q) for b, q in layouts]
        lanes = [_lanes_of_block(pair, b, q) for b, q in layouts]
        out = {"max_abs_err": _max_err(sum(got, ()), sum(want, ())),
               "layouts": len(layouts),
               "lanes": sum(int(m.sum()) for m in lanes) / len(layouts),
               "hits": sum(int((w[0][m] != 0).sum())
                           for w, m in zip(want, lanes)) / len(layouts),
               **_mean_bound([query_bound(pair, keys, b, q, w[1])
                              for (b, q), w in zip(layouts, want)])}
        raw = {"device_ms": launch("probe")}
        if dev.type == "cuda":
            for i in range(len(layouts)):
                launch("staged")(i)
            out["staged_max_abs_err"] = _max_err(sum(outs, ()),
                                                 sum(want, ()))
            raw["staged_device_ms"] = launch("staged")
        return _lookup_times(
            out, raw, lambda i: K.query_grid(pair, keys, counts, *at(i)),
            lambda: ref.query_grid_plain(pair, keys, counts, blocks, q2),
            reps, dev, cold=True)

    return _shares(_counted(run))


def _lookup_times(out: Dict, raw: Dict[str, Callable[[int], object]],
                  wrapper: Callable[[int], object],
                  plain: Callable[[], object], reps: int, dev,
                  cold: bool) -> Dict:
    """``out`` with the times of a kernel that leaves its inputs as they
    were. On the card: the first of the ``raw`` launches (the path's
    kernel) from Python (``ms``) and the wrapper (``wrapper_ms``) in
    turns; the device time of each of ``raw`` under its own name, cold
    with ``cold`` (an L2 flush before every call) and then warm as well
    (``warm_`` + its name), else warm. Elsewhere the wrapper (the plain
    version) on the host clock (``ms``). Then the plain version."""
    if dev.type == "cuda":
        out.update(in_turns({"ms": next(iter(raw.values())),
                             "wrapper_ms": wrapper}, reps, dev))
        out.update(device_ms(raw, reps, dev,
                             L2_FLUSH_BYTES if cold else 0))
        if cold:
            out.update({f"warm_{name}": t for name, t in
                        device_ms(raw, reps, dev).items()})
    else:
        out["ms"] = time_ms(lambda: wrapper(0), reps, None, dev)
    out["plain_ms"] = time_ms(plain, reps, None, dev)
    return out


def check_query(pair: Pow2Hash, table, q_keys, qchunk: int = 128,
                reps: int = 5) -> Dict:
    """The 1-D ``query`` wrapper: keys sorted by block, chunks of
    ``qchunk`` answered against their first key's block (the raw launches
    over that layout give ``ms`` and the device times), on every lane."""
    keys, counts, _ = table
    dev = keys.device
    q = q_keys[torch.sort(pair.s(q_keys), stable=True).indices].contiguous()
    q2 = q.reshape(-1, qchunk)
    blocks = pair.s(q2[:, 0]).contiguous()
    outs = [torch.empty_like(q2), torch.empty_like(q2)]

    def launch(variant):
        return lambda _: K._launch_query_grid(pair, keys, counts, blocks, q2,
                                              *outs, variant)

    def run() -> Dict:
        got = K.query(pair, keys, counts, q, qchunk)
        want2 = ref.query_grid_plain(pair, keys, counts, blocks, q2)
        out = {"max_abs_err": _max_err(got, [w.reshape(-1) for w in want2]),
               **query_bound(pair, keys, blocks, q2, want2[1])}
        raw = {"device_ms": launch("probe")}
        if dev.type == "cuda":
            raw["staged_device_ms"] = launch("staged")
        return _lookup_times(
            out, raw, lambda _: K.query(pair, keys, counts, q, qchunk),
            lambda: ref.query_grid_plain(pair, keys, counts, blocks, q2),
            reps, dev, cold=True)

    return _shares(_counted(run))


def check_filter_probe_grid(table, blocks, q2, reps: int = 5,
                            rotation: Sequence[Layout] = ()) -> Dict:
    """``filter_probe_grid`` against its plain version on every lane of
    ``(blocks, q2)`` and of each of ``rotation``'s (call ``i`` of a turn
    takes layout ``i``); on the card device times warm (the filter rows
    stay in the L2 on the path too) beside the copy floor."""
    filt = table[2]
    dev = filt.device
    layouts = [(blocks, q2), *rotation]
    at = lambda i: layouts[i % len(layouts)]
    mays = [torch.empty_like(q) for _, q in layouts]

    def run() -> Dict:
        want = [ref.filter_probe_grid_plain(filt, b, q) for b, q in layouts]
        got = [K.filter_probe_grid(filt, b, q) for b, q in layouts]
        out = {"max_abs_err": _max_err(got, want),
               "layouts": len(layouts),
               "maybe": sum(int(w.sum()) for w in want) / len(layouts),
               **_mean_bound([filter_bound(filt, b, q) for b, q in layouts])}
        raw = {"device_ms": lambda i: K._launch_filter_probe_grid(
            filt, *at(i), mays[i % len(layouts)])}
        if dev.type == "cuda":
            raw["copy_device_ms"] = lambda i: mays[i % len(layouts)].copy_(
                at(i)[1])
        return _lookup_times(
            out, raw, lambda i: K.filter_probe_grid(filt, *at(i)),
            lambda: ref.filter_probe_grid_plain(filt, blocks, q2), reps, dev,
            cold=False)

    return _shares(_counted(run))


def filter_bound(filter_words, blocks, q2) -> Dict:
    """What ``filter_probe_grid`` must move and compute: each non-EMPTY
    lane reads the sector of its first bit's word, and of its second
    bit's word only when the first bit is set; block ids and queries are
    read and the mask written in full."""
    n_b, fw = filter_words.shape
    n_rows, qcap = q2.shape
    live = q2 != EMPTY
    p0, p1 = bloom_positions(q2, filter_bits_log2(fw))
    rows = filter_words[blocks.long()]
    w0 = torch.gather(rows, 1, (p0 >> 5).long())
    first = live & (((w0 >> (p0 & 31).to(_I32)) & 1) != 0)
    need = word_sectors(p0 >> 5, live, fw) | word_sectors(p1 >> 5, first, fw)
    n_bytes = (SECTOR * _per_block(need, blocks, n_b)
               + 4 * (n_rows + 2 * n_rows * qcap))
    return bound(n_bytes, 8 * int(live.sum()))
