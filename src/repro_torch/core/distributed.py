"""Sharded flash-hash table: the paper's design across shards.

The data segment is split over ``num_shards`` shards by *block id*; the
two-level hash gives the owner for free:

    owner(x) = s(x) >> log2(blocks_per_shard)

Each shard runs the single-table policy (:mod:`.table_torch`) over its own
blocks. A sharded update is: per-shard dedup of the shard's slice of the
batch → bucket the deduped entries by owner → one ``all_to_all`` → each
owner stages / merges what it received. The only traffic between shards
is that one fixed-shape collective per wave, and every write lands
block-local on its owner. Fixed-capacity buckets (``bucket_cap`` entries
per (source, destination) pair) keep the collective's shape static; what
overflows a bucket comes back as carry.

This is the counterpart of the reference package's ``distributed``
module, written the torch way. There, ``shard_map``'d programs run over
one stacked global state; here a :class:`ShardGroup` knows which shards
this process owns and where each lives, and the programs are plain
functions over a list of per-shard ``DeviceTableState`` records, each on
its own device with its local shapes. So the reference's ``_squeeze`` /
``_expand`` (which reshape scalar leaves into and out of ``shard_map``)
have no counterpart, and neither do ``host_shards``, ``place_global``,
``make_global_batch`` and ``make_replicated``: a process holds only its
own shards, which is what :attr:`ShardGroup.local_shards` names.
:func:`global_arrays` and :func:`from_global_arrays` map to and from the
reference's stacked layout (leading dim ``num_shards * local``, scalar
leaves tiled to ``(n,)``, MDB's ``(cs_partitions,)`` log pointers to
``(n * cs_partitions,)``); snapshots and the parity tests use it.

The group's collectives are local in one process (a transpose of the
buckets, each row moved to its owner's device; sums and maxima over the
shards) and go through ``torch.distributed`` when the group has a process
group: ``all_to_all_single`` with equal splits, ``all_reduce(SUM)`` and
``all_reduce(MAX)``. The process group's backend is the caller's. With
gloo the group always stages its collective buffers through host memory
(gloo's ``all_to_all`` takes CPU tensors); with NCCL they stay on the
rank's card.

Update and flush consume their input states like :mod:`.table_torch`'s
(``assert_live`` refuses a consumed one); the sharded store runs them on
its drain worker, one drain in flight.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import table_torch as tt
from .hashing import Pow2Hash

EMPTY = tt.EMPTY
assert_live = tt.assert_live
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShardedTableConfig:
    local: tt.FlashTableConfig = dataclasses.field(
        default_factory=tt.FlashTableConfig)
    num_shards: int = 1
    bucket_cap: int = 1 << 12     # entries per (src, dst) bucket per wave

    @property
    def global_blocks(self) -> int:
        return self.local.num_blocks * self.num_shards

    @property
    def global_pair(self) -> Pow2Hash:
        c = self.local
        shard_log2 = (self.num_shards - 1).bit_length()
        return Pow2Hash(q_log2=c.q_log2 + shard_log2, r_log2=c.r_log2)


def owner_of(cfg: ShardedTableConfig, keys: torch.Tensor) -> torch.Tensor:
    """Owner shard per key: the global block id's top (shard) bits. With
    power-of-two geometry and a shared multiplier the local block is the
    global block ``& (n_b_local - 1)`` and the home-within-block bits are
    the same, so owner routing and local placement agree."""
    return cfg.global_pair.s(keys) >> (cfg.local.q_log2 - cfg.local.r_log2)


def _bucket_by_owner(cfg: ShardedTableConfig, keys, cnts):
    """Pack deduped updates into ``(num_shards, bucket_cap)`` owner
    buckets: a stable sort by owner (EMPTY owned by ``n``), each owner's
    run from the front of its row. Entries past ``bucket_cap`` come back
    as carry ``(keys, counts)`` in the sorted order, EMPTY elsewhere."""
    n = cfg.num_shards
    cap = cfg.bucket_cap
    valid = keys != EMPTY
    owner = torch.where(valid, owner_of(cfg, keys).long(), n)
    order = torch.argsort(owner, stable=True)
    sk, sc, so = keys[order], cnts[order], owner[order]
    start = torch.searchsorted(
        so, torch.arange(n + 1, dtype=so.dtype, device=so.device))
    pos = torch.arange(keys.shape[0], device=keys.device) \
        - start[so.clamp(0, n)]
    keep = (so < n) & (pos < cap)
    row = torch.where(keep, so, n)
    col = torch.where(keep, pos, 0)
    # row n collects what is not kept and is cut off below
    buk = torch.full((n + 1, cap), EMPTY, dtype=_I32, device=keys.device)
    buc = torch.zeros((n + 1, cap), dtype=_I32, device=keys.device)
    buk[row, col] = sk.to(_I32)
    buc[row, col] = sc.to(_I32)
    dropped = (so < n) & ~keep
    carry_k = torch.where(dropped, sk, EMPTY)
    carry_c = torch.where(dropped, sc, 0)
    return buk[:n], buc[:n], carry_k, carry_c


def resolve_devices(device="cuda", distributed: bool = False
                    ) -> List[torch.device]:
    """The devices the local shards live on. A list is taken as given;
    ``"cuda"`` without an index is every visible card in one process and
    the current card in a process of a group; anything else is the one
    device it names. A CUDA device without a card raises."""
    if isinstance(device, (list, tuple)):
        return [tt.resolve_device(d) for d in device]
    dev = tt.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if distributed:
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class ShardStates(list):
    """The local shards' states in shard order. ``device`` is the first
    local shard's: the query engine builds its key chunks there."""

    @property
    def device(self) -> torch.device:
        return self[0].device


class ShardGroup:
    """The shards of one process and the collectives over all of them.

    ``num_shards`` shards split evenly over the process group's ranks
    (contiguous, ``num_shards / world_size`` each; an uneven split is
    refused). Local shard ``i`` lives on ``devices[i % len(devices)]``.
    Without a process group the group holds every shard and its
    collectives are local; with one, ``all_to_all`` / ``psum`` / ``pmax``
    are ``torch.distributed`` collectives on it, in the same order on
    every rank. Under gloo every collective buffer is staged through host
    memory, always; under another backend it stays on the first local
    shard's device."""

    def __init__(self, num_shards: int, devices: Sequence,
                 process_group=None):
        import torch.distributed as dist
        n = int(num_shards)
        self.num_shards = n
        self.process_group = process_group
        if process_group is None:
            self.world_size, self.rank = 1, 0
            self.backend = "local"
        else:
            self.world_size = dist.get_world_size(process_group)
            self.rank = dist.get_rank(process_group)
            self.backend = str(dist.get_backend(process_group))
        if n % self.world_size:
            raise ValueError(f"num_shards={n} does not split evenly over "
                             f"{self.world_size} processes")
        per = n // self.world_size
        self.local_shards = list(range(self.rank * per,
                                       (self.rank + 1) * per))
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a shard group needs at least one device")
        self.devices = [devices[i % len(devices)] for i in range(per)]
        self.home = self.devices[0]
        self._comm = (torch.device("cpu") if self.backend == "gloo"
                      else self.home)

    @property
    def distributed(self) -> bool:
        return self.process_group is not None

    def placement(self) -> str:
        """Where the local shards live, e.g. ``4 shards on cuda:0``."""
        per = collections.Counter(str(d) for d in self.devices)
        where = "; ".join(f"{c} shard{'s' if c > 1 else ''} on {d}"
                          for d, c in per.items())
        if self.distributed:
            return (f"rank {self.rank} of {self.world_size}: shards "
                    f"{self.local_shards[0]}-{self.local_shards[-1]}, "
                    f"{where}")
        return where

    # -- collectives ---------------------------------------------------------
    def all_to_all(self, send: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``send[i]`` is local shard ``i``'s ``(num_shards, ...)`` buckets,
        row ``d`` for shard ``d``. Returns, for each local shard, the
        ``(num_shards, ...)`` rows addressed to it, row ``j`` from shard
        ``j``, on that shard's device."""
        n = self.num_shards
        if not self.distributed:
            return [torch.stack([send[s][d].to(self.devices[d])
                                 for s in range(n)])
                    for d in range(n)]
        import torch.distributed as dist
        per, w = len(self.local_shards), self.world_size
        rest = tuple(send[0].shape[1:])
        # x[r, d, s]: local source s's row for destination r * per + d
        x = torch.stack([t.to(self._comm) for t in send], dim=1)
        x = x.reshape((w, per, per) + rest).contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.process_group)
        # out[r, d, s]: rank r's source s to my destination d
        got = out.transpose(0, 1).reshape((per, n) + rest)
        return [got[d].to(self.devices[d]) for d in range(per)]

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if not self.distributed:
            return t
        import torch.distributed as dist
        buf = t.to(self._comm, copy=True).contiguous()
        dist.all_reduce(buf, op=op, group=self.process_group)
        return buf.to(t.device)

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over every shard: the local parts on the home device, then
        across processes."""
        tot = parts[0].to(self.home)
        for p in parts[1:]:
            tot = tot + p.to(self.home)
        import torch.distributed as dist
        return self._all_reduce(tot, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Element-wise maximum over the processes (the drain agreement)."""
        import torch.distributed as dist
        return self._all_reduce(t, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# the programs: plain functions over (config, group, local shard states)
# ---------------------------------------------------------------------------
def init_states(cfg: ShardedTableConfig, group: ShardGroup) -> ShardStates:
    return ShardStates(tt.init(cfg.local, d) for d in group.devices)


def update(cfg: ShardedTableConfig, group: ShardGroup,
           states: Sequence[tt.DeviceTableState],
           tokens: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor]
           ) -> Tuple[ShardStates, int]:
    """One wave: local shard ``i`` contributes ``(tokens[i], deltas[i])``
    (its slice of the global batch). Each shard dedups its slice, buckets
    it by owner, the group exchanges the buckets, and every shard stages
    the ``num_shards * bucket_cap`` entries it received. Consumes
    ``states``; returns the new states and the entries carried over (the
    sum over every shard)."""
    send, carry = [], []
    for dev, t, d in zip(group.devices, tokens, deltas):
        keys, cnts = tt.accumulate_deltas(t.to(dev, _I32), d.to(dev, _I32))
        buk, buc, carry_k, _ = _bucket_by_owner(cfg, keys, cnts)
        send.append(torch.stack([buk, buc], dim=-1))
        carry.append((carry_k != EMPTY).sum(dtype=_I32))
    got = group.all_to_all(send)
    new = ShardStates()
    for st, g in zip(states, got):
        g = g.reshape(-1, 2)
        new.append(tt.update(cfg.local, st, g[:, 0].contiguous(),
                             g[:, 1].contiguous()))
    return new, int(group.psum(carry))


def flush(cfg: ShardedTableConfig,
          states: Sequence[tt.DeviceTableState]) -> ShardStates:
    """Every local shard merges its staged change segment. No collective:
    merges are block-local."""
    return ShardStates(tt.flush(cfg.local, s) for s in states)


def _masked(cfg, shard: int, q: torch.Tensor):
    mine = owner_of(cfg, q) == shard
    return mine, torch.where(mine, q, EMPTY)


def lookup_ex(cfg: ShardedTableConfig, group: ShardGroup,
              states: Sequence[tt.DeviceTableState], q_keys
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every shard queries the whole batch against its own blocks (keys
    it does not own masked EMPTY); one sum combines. Returns ``(counts,
    probe distances, tile loads summed over the shards)`` on the home
    device, ``table_torch.lookup_ex``'s contract."""
    parts = []
    for shard, dev, st in zip(group.local_shards, group.devices, states):
        q = q_keys.to(dev, _I32)
        mine, masked = _masked(cfg, shard, q)
        cnt, dist, tiles = tt.lookup_ex(cfg.local, st, masked)
        zero = torch.zeros_like(cnt)
        parts.append(torch.cat([torch.where(mine, cnt, zero),
                                torch.where(mine, dist.to(cnt.dtype), zero),
                                tiles.reshape(1).to(cnt.dtype)]))
    tot = group.psum(parts)
    m = q_keys.shape[0]
    return tot[:m], tot[m:2 * m], tot[2 * m]


def filter_probe(cfg: ShardedTableConfig, group: ShardGroup,
                 states: Sequence[tt.DeviceTableState], q_keys
                 ) -> torch.Tensor:
    """The Bloom pre-filter across shards: each shard tests the batch
    against its own per-block filters (keys it does not own test 0); one
    sum combines. An int32 may-contain mask, 0 ⇒ absent everywhere."""
    parts = []
    for shard, dev, st in zip(group.local_shards, group.devices, states):
        q = q_keys.to(dev, _I32)
        mine, masked = _masked(cfg, shard, q)
        parts.append((mine & tt.filter_probe(cfg.local, st, masked))
                     .to(_I32))
    return group.psum(parts)


def synchronize(states: Sequence[tt.DeviceTableState]) -> None:
    """Wait until every device really holds its shard."""
    for s in states:
        tt.synchronize(s)


# ---------------------------------------------------------------------------
# the reference's stacked global layout
# ---------------------------------------------------------------------------
def global_arrays(states: Sequence[tt.DeviceTableState]) -> Dict:
    """The shards' states stacked into the reference's global layout, as
    numpy (``convert.state_to_numpy``'s record: filter words uint32,
    ``stats`` a dict). Takes every shard, in shard order."""
    from .. import convert
    per = [convert.state_to_numpy(s) for s in states]
    cat = lambda xs: np.concatenate([np.atleast_1d(x) for x in xs])
    out = {f: cat([p[f] for p in per]) for f in per[0] if f != "stats"}
    out["stats"] = {f: cat([p["stats"][f] for p in per])
                    for f in per[0]["stats"]}
    return out


def from_global_arrays(cfg: ShardedTableConfig, arrays, group: ShardGroup
                       ) -> ShardStates:
    """The local shards' states from a global-layout record (the dict
    :func:`global_arrays` gives, or a snapshot's arrays unflattened),
    each on its shard's device. A leaf of another geometry raises."""
    from .. import convert
    like = tt.init(cfg.local, "meta")        # local shapes, no storage
    n = cfg.num_shards

    def take(a, local, name: str, shard: int):
        a = np.asarray(a)
        shape = tuple(local.shape)
        rows = shape[0] if shape else 1
        want = (n * rows,) + shape[1:]
        if tuple(a.shape) != want:
            raise ValueError(f"{name}: shape {a.shape} != {want}")
        return a[shard * rows:(shard + 1) * rows].reshape(shape)

    out = ShardStates()
    for shard, dev in zip(group.local_shards, group.devices):
        rec = {f: take(arrays[f], getattr(like, f), f, shard)
               for f in like._fields if f != "stats"}
        rec["stats"] = {f: take(arrays["stats"][f], getattr(like.stats, f),
                                f"stats/{f}", shard)
                        for f in like.stats._fields}
        out.append(convert.state_from_numpy(rec, device=dev))
    return out


__all__ = ["ShardedTableConfig", "ShardGroup", "ShardStates", "EMPTY",
           "assert_live", "owner_of", "resolve_devices", "init_states",
           "update", "flush", "lookup_ex", "filter_probe", "synchronize",
           "global_arrays", "from_global_arrays"]
