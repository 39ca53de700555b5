"""Carry state between the reference package and this one: a device
table's state, and a model's parameters.

The reference keeps its ``DeviceTableState`` as JAX arrays; mapping it to
numpy (``jax.tree.map(np.asarray, state)``) gives a record of numpy
arrays with the same field names. :func:`state_from_numpy` takes that
record (or the dict :func:`state_to_numpy` returns) onto a device;
:func:`state_to_numpy` brings a port state back as a dict of numpy
arrays, ``stats`` a dict of 0-d int32 arrays. Filter words are uint32 on
the reference side and int32 with the same bits here: the ``.view`` at
this boundary is the only conversion.

:func:`params_from_numpy` takes the reference's ``init_params`` pytree
mapped to numpy and returns the port's ``Model`` ``state_dict``;
:func:`params_to_numpy` is its inverse (:func:`params_to_host` the same
with CPU tensors as leaves, so a bf16 leaf keeps its type without
``ml_dtypes``). :func:`opt_state_from_numpy` / :func:`opt_state_to_numpy`
do the same for an ``AdamWState``: ``m`` and ``v`` in the parameters'
layout, ``count`` a 0-d int32. Together they carry a train state between
the packages; the checkpoint layer writes it under the reference's names
(``params/groups/0/mixer/wq``, ``opt/m/...``, ``opt/count``).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .core.segments import DeviceTableState, TableStats


def _get(rec, name):
    return rec[name] if isinstance(rec, dict) else getattr(rec, name)


def state_from_numpy(arrays, device="cuda") -> DeviceTableState:
    """A port state on ``device`` from numpy arrays (an attribute record
    or a dict with the field names; ``stats`` likewise)."""
    from .core.table_torch import resolve_device
    dev = resolve_device(device)

    def put(a, dtype=np.int32):
        a = np.asarray(a)
        if a.dtype != dtype:
            raise TypeError(f"expected {np.dtype(dtype)}, got {a.dtype}")
        if dtype == np.uint32:
            a = a.view(np.int32)
        # np.array keeps 0-d pointers and counters 0-d (ascontiguousarray
        # would make them 1-d)
        return torch.as_tensor(np.array(a, order="C"), device=dev)

    stats = _get(arrays, "stats")
    return DeviceTableState(
        keys=put(_get(arrays, "keys")),
        counts=put(_get(arrays, "counts")),
        log_keys=put(_get(arrays, "log_keys")),
        log_counts=put(_get(arrays, "log_counts")),
        log_ptr=put(_get(arrays, "log_ptr")),
        ov_keys=put(_get(arrays, "ov_keys")),
        ov_counts=put(_get(arrays, "ov_counts")),
        ov_ptr=put(_get(arrays, "ov_ptr")),
        filter_words=put(_get(arrays, "filter_words"), np.uint32),
        stats=TableStats(*(put(_get(stats, f)) for f in TableStats._fields)),
    )


def state_to_numpy(state: DeviceTableState) -> Dict:
    """Every field of ``state`` as numpy arrays in the reference's dtypes
    (filter words as uint32), ``stats`` as a dict of 0-d arrays."""
    host = lambda t: t.detach().cpu().numpy().copy()
    out = {f: host(getattr(state, f)) for f in DeviceTableState._fields
           if f != "stats"}
    out["filter_words"] = out["filter_words"].view(np.uint32)
    out["stats"] = {f: host(getattr(state.stats, f))
                    for f in TableStats._fields}
    return out


# ---------------------------------------------------------------------------
# model parameters
# ---------------------------------------------------------------------------
def _tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor from a numpy leaf; a bf16 leaf (``ml_dtypes``'
    bfloat16, as JAX gives it) is carried by its 16-bit pattern. A tensor
    leaf is taken as it is."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """The inverse: bf16 as numpy's ``bfloat16`` where a module has
    registered that name (``ml_dtypes``, loaded beside JAX), else as its
    uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            return bits.view(np.dtype("bfloat16"))
        except TypeError:
            return bits
    return t.numpy().copy()


def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _walk(v, name + ".")
        else:
            yield name, v


def params_from_numpy(cfg, tree) -> Dict[str, torch.Tensor]:
    """The port's ``Model`` ``state_dict`` (CPU tensors) from the
    reference's parameter pytree with numpy leaves. The reference stacks
    each group slot on a leading ``layers`` axis; layer ``g * G + slot``
    of the port is row ``g`` of slot ``slot`` (G = group size), whatever
    its mixer (GQA, MLA, SSM) and FFN (dense, MoE, none). Every leaf
    keeps its dtype: the MoE router and the SSM's ``a_log`` / ``d_skip``
    / ``dt_bias`` are f32 in a bf16 model, as the port's modules hold
    them."""
    sd = {f"embed.{n}": _tensor_from_numpy(a)
          for n, a in _walk(tree["embed"])}
    sd.update({f"final_norm.{n}": _tensor_from_numpy(a)
               for n, a in _walk(tree["final_norm"])})
    G = cfg.group_size
    for slot, group in enumerate(tree["groups"]):
        for n, a in _walk(group):
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
            if a.shape[0] != cfg.num_groups:
                raise ValueError(f"groups[{slot}].{n}: leading axis "
                                 f"{a.shape[0]} != {cfg.num_groups} groups")
            for g in range(cfg.num_groups):
                sd[f"layers.{g * G + slot}.{n}"] = _tensor_from_numpy(a[g])
    return sd


def _nest(items) -> Dict:
    out: Dict = {}
    for name, leaf in items:
        *path, last = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _stacked(cfg, host: Dict, stack) -> Dict:
    """The reference's parameter layout from per-layer leaves (``host``:
    state_dict names → arrays), each group slot stacked with ``stack``."""
    G = cfg.group_size
    groups = []
    for slot in range(G):
        names = sorted({k.split(".", 2)[2] for k in host
                        if k.startswith(f"layers.{slot}.")})
        groups.append(_nest(
            (n, stack([host[f"layers.{g * G + slot}.{n}"]
                       for g in range(cfg.num_groups)]))
            for n in names))
    return {"embed": _nest((k[len("embed."):], v) for k, v in host.items()
                           if k.startswith("embed.")),
            "groups": groups,
            "final_norm": _nest((k[len("final_norm."):], v)
                                for k, v in host.items()
                                if k.startswith("final_norm."))}


def params_to_numpy(cfg, state_dict) -> Dict:
    """The reference's parameter pytree (numpy leaves, layers stacked per
    group slot) from a port ``state_dict``."""
    return _stacked(cfg, {k: _numpy_from_tensor(v)
                          for k, v in state_dict.items()}, np.stack)


def params_to_host(cfg, state_dict) -> Dict:
    """:func:`params_to_numpy` with CPU tensors as leaves (every dtype
    kept, bf16 included)."""
    return _stacked(cfg, {k: v.detach().cpu() for k, v in state_dict.items()},
                    torch.stack)


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------
def opt_state_from_numpy(cfg, tree, device="cuda"):
    """The port's ``AdamWState`` on ``device`` from the reference's (an
    ``AdamWState`` mapped to numpy, or a dict with ``m``, ``v``,
    ``count``); leaves may be numpy arrays or tensors."""
    from .core.table_torch import resolve_device
    from .optim.adamw import AdamWState
    dev = resolve_device(device)

    def put(t):
        return {k: v.to(dev) for k, v in params_from_numpy(cfg, t).items()}

    count = _tensor_from_numpy(_get(tree, "count")).to(torch.int32)
    return AdamWState(m=put(_get(tree, "m")), v=put(_get(tree, "v")),
                      count=count.reshape(()).to(dev))


def opt_state_to_host(cfg, state) -> Dict:
    """``{"m", "v", "count"}`` in the reference's layout, CPU tensors."""
    return {"m": params_to_host(cfg, state.m),
            "v": params_to_host(cfg, state.v),
            "count": state.count.detach().cpu().to(torch.int32)}


def opt_state_to_numpy(cfg, state) -> Dict:
    """The reference's ``AdamWState`` fields as a dict of numpy trees
    (``count`` a 0-d int32 array)."""
    return {"m": params_to_numpy(cfg, state.m),
            "v": params_to_numpy(cfg, state.v),
            "count": state.count.detach().cpu().numpy().astype(np.int32)}
