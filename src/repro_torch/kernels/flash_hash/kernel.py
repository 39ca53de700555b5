"""Wrappers of the flash-hash CUDA kernels (``csrc/flash_hash.cu``).

Each wrapper checks device, dtype, shape and contiguity, then:

* for tensors on the CPU, runs the kernel's plain version from
  :mod:`.ref` (the CPU tests' path);
* for CUDA tensors, launches the CUDA kernel on the current stream, or
  raises. There is no fallback from the card to the plain version.

The data segment is updated **in place** (the reference package donates
these buffers): ``merge``/``merge_dirty`` return the very ``table_keys``,
``table_counts`` and ``filter_words`` tensors they were given. Filter
words are int32 tensors holding the reference's uint32 bits.

Each wrapper is its checks (one host sync, in :func:`_check_ids`) and a
raw launch (``_launch_*``: checked CUDA tensors and preallocated outputs
in, no checks, no sync), which ``check.py`` times on its own.

``LAUNCHES`` counts CUDA launches per kernel of the paths; only a launch
adds to it. The merge has three routes, fixed by the block width alone
(:func:`merge_route`): the staged fold for blocks of 8 to 8192 slots, the
cluster fold for 2**14 to 2**17 (the tile striped over a thread-block
cluster's shared memory, by :func:`cluster_plan`) and the in-place fold
for every other width; ``MERGE_ROUTES`` counts each merge launch under its
route as well. ``BASELINE_LAUNCHES`` counts the kernels the path's kernels
replaced (the serial merge, the staged query), which only ``check.py``
launches, through the raw launches' ``variant``.
"""
from __future__ import annotations

import dataclasses

import torch

from ...core.hashing import Pow2Hash
from . import ref

EMPTY = ref.EMPTY

#: shared memory one CTA can opt into on an H100 (bytes)
SMEM_OPT_IN = 227 * 1024
#: CUDA launches per kernel (a plain int each; reset by assigning 0)
LAUNCHES = {"merge_dirty": 0, "query_grid": 0, "filter_probe_grid": 0}
#: CUDA launches of the replaced kernels, the in-turn "before"s
BASELINE_LAUNCHES = {"merge_dirty_serial": 0, "query_grid_staged": 0}
#: CUDA launches of the merge by route (each also counts in ``LAUNCHES``)
MERGE_ROUTES = {"staged": 0, "cluster": 0, "in_place": 0}
#: block widths (log2) the staged fold takes, and the cluster fold; every
#: other width takes the in-place fold
STAGED_R_LOG2 = range(3, 14)
CLUSTER_R_LOG2 = range(14, 18)
#: C entry points of each kernel by variant. The merge's ``per_row`` (not
#: a key here) is the path's, its route by :func:`merge_route`; ``staged``,
#: ``cluster`` and ``in_place`` name each route (``in_place`` takes every
#: width, and is the cluster route's in-turn "before"), ``serial`` the
#: staged one's baseline. The query's ``probe`` serves every path and
#: ``staged`` is its baseline. Baselines are timed by ``check.py`` only
MERGE_ENTRIES = {"staged": "fh_merge_dirty",
                 "cluster": "fh_merge_dirty_cluster",
                 "in_place": "fh_merge_dirty_in_place",
                 "serial": "fh_merge_dirty_serial"}
QUERY_ENTRIES = {"probe": "fh_query_grid", "staged": "fh_query_grid_staged"}

#: the cluster fold's layout (``csrc/flash_hash.cu``: ``ClusterSmem``):
#: updates folded a chunk at a time, the entries of a CTA's hash of new
#: keys, its scalars (ints), and a CTA's stripe of the tile (log2 slots):
#: 2**14 to 2**17 slots take clusters of 1 to 8 CTAs
MERGE_CHUNK = 1024
CLUSTER_HASH = 2 * MERGE_CHUNK
CLUSTER_SCALARS = 8
CLUSTER_STRIPE_LOG2 = 14


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How the cluster fold lays out a tile: ``cluster`` CTAs, each a
    stripe of ``2**stripe_log2`` slots of keys in ``smem_bytes`` of shared
    memory."""

    cluster: int
    stripe_log2: int
    smem_bytes: int


def cluster_plan(r_log2: int) -> ClusterPlan:
    """The cluster fold's plan for blocks of ``2**r_log2`` slots (one of
    :data:`CLUSTER_R_LOG2`), from the width alone. The entry point checks
    the plan against its own layout."""
    if r_log2 not in CLUSTER_R_LOG2:
        raise ValueError(f"the cluster fold takes blocks of 2**14 to 2**17 "
                         f"slots, not 2**{r_log2}")
    nw = (1 << r_log2) >> 5
    ints = ((1 << CLUSTER_STRIPE_LOG2) + nw + (nw >> 5) + 6 * MERGE_CHUNK
            + CLUSTER_HASH + CLUSTER_SCALARS)
    return ClusterPlan(1 << (r_log2 - CLUSTER_STRIPE_LOG2),
                       CLUSTER_STRIPE_LOG2, 4 * ints + 8)


def cluster_capacity(plan: ClusterPlan) -> int:
    """How many clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``): a launch of ``n_d`` rows takes
    ``ceil(n_d / capacity)`` waves. Raises where the query fails."""
    n = _lib().fh_merge_cluster_capacity(plan.cluster, plan.smem_bytes)
    if n < 0:
        raise RuntimeError(f"cluster capacity: cudaError {-n}")
    return n


def merge_route(r_log2: int) -> str:
    """The merge's route for blocks of ``2**r_log2`` slots, fixed by the
    width alone: ``"staged"`` (the whole tile in one CTA's shared memory)
    for 8 to 8192 slots, ``"cluster"`` (the tile striped over a cluster's
    shared memory) for 2**14 to 2**17, ``"in_place"`` (the tile folded in
    global memory) for every other width."""
    if r_log2 in STAGED_R_LOG2:
        return "staged"
    return "cluster" if r_log2 in CLUSTER_R_LOG2 else "in_place"


def serial_fits(r_log2: int, fw: int) -> bool:
    """Whether the serial baseline can stage a tile of ``2**r_log2`` slots
    and ``fw`` filter words in one CTA's shared memory (227 KB on an
    H100): up to 16,384 slots."""
    return (2 * (1 << r_log2) + fw) * 4 <= SMEM_OPT_IN


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_ids(ids: torch.Tensor, n_b: int, unique_rows=None) -> None:
    """Block ids in ``[0, n_b)``; with ``unique_rows`` (a bool row mask),
    no id may repeat among the selected rows. One host sync."""
    bad = ((ids < 0) | (ids >= n_b)).any()
    if unique_rows is not None:
        sel = torch.sort(ids[unique_rows]).values
        bad = bad | (sel[1:] == sel[:-1]).any()
    if bool(bad):
        raise ValueError(
            "block ids must lie in [0, n_b)"
            + ("" if unique_rows is None else
               " and a repeated id may not carry updates (two CTAs would "
               "race on one tile)"))


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _lib():
    from .build import load
    return load()


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def merge_dirty(pair: Pow2Hash, table_keys, table_counts, filter_words,
                dirty_blocks, upd_keys, upd_counts):
    """Fold update row ``i`` into block ``dirty_blocks[i]``, in place.

    table_keys/table_counts: (n_b, r) int32; filter_words: (n_b, fw)
    int32; dirty_blocks: (n_d,) int32; upd_keys/upd_counts: (n_d, max_u)
    int32, EMPTY-padded. A block id may repeat only on rows without a
    valid update. Returns ``(table_keys, table_counts, filter_words,
    spill_keys, spill_counts)``, the spills ``(n_d, max_u)``. On the card
    every block width runs, through the route :func:`merge_route` names
    for it."""
    n_b, r = pair.num_slots, pair.r
    dev = table_keys.device
    fw = filter_words.shape[1] if filter_words.dim() == 2 else -1
    n_d = dirty_blocks.shape[0] if dirty_blocks.dim() == 1 else -1
    max_u = upd_keys.shape[1] if upd_keys.dim() == 2 else -1
    _check("table_keys", table_keys, (n_b, r), dev)
    _check("table_counts", table_counts, (n_b, r), dev)
    _check("filter_words", filter_words, (n_b, fw), dev)
    _check("dirty_blocks", dirty_blocks, (n_d,), dev)
    _check("upd_keys", upd_keys, (n_d, max_u), dev)
    _check("upd_counts", upd_counts, (n_d, max_u), dev)
    _check_ids(dirty_blocks, n_b, (upd_keys != EMPTY).any(1))
    if dev.type == "cpu":
        return ref.merge_dirty_plain(pair, table_keys, table_counts,
                                     filter_words, dirty_blocks, upd_keys,
                                     upd_counts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    spill_k = torch.empty((n_d, max_u), dtype=torch.int32, device=dev)
    spill_c = torch.empty((n_d, max_u), dtype=torch.int32, device=dev)
    _launch_merge_dirty(pair, table_keys, table_counts, filter_words,
                        dirty_blocks, upd_keys, upd_counts, spill_k, spill_c)
    return table_keys, table_counts, filter_words, spill_k, spill_c


def merge_scratch(pair: Pow2Hash, n_d: int, device):
    """The in-place fold's scratch for ``n_d`` listed rows (its free
    bitmaps, where shared memory cannot hold them: blocks past 2**20
    slots), or None where it needs none."""
    words = _lib().fh_merge_scratch_words(pair.r_log2)
    if not words:
        return None
    return torch.empty(n_d * words, dtype=torch.int32, device=device)


def _launch_merge_dirty(pair: Pow2Hash, table_keys, table_counts,
                        filter_words, dirty_blocks, upd_keys, upd_counts,
                        spill_k, spill_c, variant: str = "per_row",
                        scratch=None):
    """Launch the merge on CUDA tensors :func:`merge_dirty` has checked,
    into ``spill_k``/``spill_c`` of ``upd_keys``' shape: ``variant`` is
    ``"per_row"`` (the route :func:`merge_route` picks) or a key of
    :data:`MERGE_ENTRIES`. The in-place route takes ``scratch``
    (:func:`merge_scratch`), allocated here if not given; the cluster
    route :func:`cluster_plan`'s plan. A refused launch raises: no route
    stands in for another."""
    n_d, max_u = upd_keys.shape
    if not (n_d and max_u):
        return
    route = merge_route(pair.r_log2) if variant == "per_row" else variant
    args = [dirty_blocks.data_ptr(), n_d, table_keys.data_ptr(),
            table_counts.data_ptr(), filter_words.data_ptr(), pair.r_log2,
            filter_words.shape[1], upd_keys.data_ptr(),
            upd_counts.data_ptr(), max_u, spill_k.data_ptr(),
            spill_c.data_ptr(), pair.mult]
    if route == "in_place":
        if scratch is None:
            scratch = merge_scratch(pair, n_d, table_keys.device)
        args.append(0 if scratch is None else scratch.data_ptr())
    if route == "cluster":
        plan = cluster_plan(pair.r_log2)
        args += [plan.cluster, plan.smem_bytes]
    err = getattr(_lib(), MERGE_ENTRIES[route])(
        *args, _stream(table_keys.device))
    _raise_if(err, f"merge_dirty ({route})")
    if route == "serial":
        BASELINE_LAUNCHES["merge_dirty_serial"] += 1
    else:
        LAUNCHES["merge_dirty"] += 1
        MERGE_ROUTES[route] += 1


def merge(pair: Pow2Hash, table_keys, table_counts, filter_words,
          upd_keys, upd_counts):
    """:func:`merge_dirty` over every block in order (``upd_*`` are
    ``(n_b, max_u)``, row ``b`` for block ``b``)."""
    ids = torch.arange(pair.num_slots, dtype=torch.int32,
                       device=table_keys.device)
    return merge_dirty(pair, table_keys, table_counts, filter_words, ids,
                       upd_keys, upd_counts)


def query_grid(pair: Pow2Hash, table_keys, table_counts, blocks, q2):
    """Point queries over an explicit chunk layout: row ``i`` answers all
    of ``q2[i]`` against block ``blocks[i]``'s tile. Returns ``(counts,
    dists)``, each ``(n_rows, qcap)`` int32. Callers gather only the lanes
    holding keys of the row's block; the kernel answers every other lane
    (``EMPTY``, keys of another block) as the plain version does too."""
    n_b, r = pair.num_slots, pair.r
    dev = table_keys.device
    n_rows = blocks.shape[0] if blocks.dim() == 1 else -1
    qcap = q2.shape[1] if q2.dim() == 2 else -1
    _check("table_keys", table_keys, (n_b, r), dev)
    _check("table_counts", table_counts, (n_b, r), dev)
    _check("blocks", blocks, (n_rows,), dev)
    _check("q2", q2, (n_rows, qcap), dev)
    _check_ids(blocks, n_b)
    if dev.type == "cpu":
        return ref.query_grid_plain(pair, table_keys, table_counts, blocks, q2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cnt = torch.empty((n_rows, qcap), dtype=torch.int32, device=dev)
    dist = torch.empty((n_rows, qcap), dtype=torch.int32, device=dev)
    _launch_query_grid(pair, table_keys, table_counts, blocks, q2, cnt, dist)
    return cnt, dist


def _launch_query_grid(pair: Pow2Hash, table_keys, table_counts, blocks,
                       q2, cnt, dist, variant: str = "probe"):
    """Launch ``query_grid`` (``variant`` of :data:`QUERY_ENTRIES`) on
    checked CUDA tensors into ``cnt``/``dist`` of ``q2``'s shape."""
    n_rows, qcap = q2.shape
    if not (n_rows and qcap):
        return
    err = getattr(_lib(), QUERY_ENTRIES[variant])(
        table_keys.data_ptr(), table_counts.data_ptr(), blocks.data_ptr(),
        q2.data_ptr(), cnt.data_ptr(), dist.data_ptr(), n_rows, pair.r_log2,
        qcap, pair.mult, _stream(table_keys.device))
    _raise_if(err, f"query_grid ({variant})")
    if variant == "staged":
        BASELINE_LAUNCHES["query_grid_staged"] += 1
    else:
        LAUNCHES["query_grid"] += 1


def query(pair: Pow2Hash, table_keys, table_counts, q_keys, qchunk: int = 128):
    """Point queries, ``q_keys`` (Q,) int32 with ``Q % qchunk == 0``; each
    chunk is answered against the block of its first key (callers sort)."""
    (Q,) = q_keys.shape
    if Q % qchunk:
        raise ValueError(f"Q={Q} is not a multiple of qchunk={qchunk}")
    q2 = q_keys.reshape(Q // qchunk, qchunk)
    blocks = pair.s(q2[:, 0]).contiguous()
    cnt, dist = query_grid(pair, table_keys, table_counts, blocks, q2)
    return cnt.reshape(Q), dist.reshape(Q)


def filter_probe_grid(filter_words, blocks, q2):
    """Bloom pre-pass over :func:`query_grid`'s chunk layout: lane
    ``(i, j)`` tests ``q2[i, j]`` against block ``blocks[i]``'s filter row.
    Returns an ``(n_rows, qcap)`` int32 mask; 0 means definitely absent."""
    dev = filter_words.device
    n_b, fw = filter_words.shape if filter_words.dim() == 2 else (-1, -1)
    n_rows = blocks.shape[0] if blocks.dim() == 1 else -1
    qcap = q2.shape[1] if q2.dim() == 2 else -1
    _check("filter_words", filter_words, (n_b, fw), dev)
    _check("blocks", blocks, (n_rows,), dev)
    _check("q2", q2, (n_rows, qcap), dev)
    _check_ids(blocks, n_b)
    if dev.type == "cpu":
        return ref.filter_probe_grid_plain(filter_words, blocks, q2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    may = torch.empty((n_rows, qcap), dtype=torch.int32, device=dev)
    _launch_filter_probe_grid(filter_words, blocks, q2, may)
    return may


def _launch_filter_probe_grid(filter_words, blocks, q2, may):
    """Launch ``filter_probe_grid`` on checked CUDA tensors into ``may`` of
    ``q2``'s shape."""
    n_rows, qcap = q2.shape
    if not (n_rows and qcap):
        return
    err = _lib().fh_filter_probe_grid(
        filter_words.data_ptr(), blocks.data_ptr(), q2.data_ptr(),
        may.data_ptr(), n_rows, qcap, filter_words.shape[1],
        _stream(filter_words.device))
    _raise_if(err, "filter_probe_grid")
    LAUNCHES["filter_probe_grid"] += 1
