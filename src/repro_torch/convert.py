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
:func:`params_to_numpy` is its inverse.
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
    bfloat16, as JAX gives it) is carried by its 16-bit pattern."""
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
    of the port is row ``g`` of slot ``slot`` (G = group size)."""
    sd = {f"embed.{n}": _tensor_from_numpy(a)
          for n, a in _walk(tree["embed"])}
    sd.update({f"final_norm.{n}": _tensor_from_numpy(a)
               for n, a in _walk(tree["final_norm"])})
    G = cfg.group_size
    for slot, group in enumerate(tree["groups"]):
        for n, a in _walk(group):
            a = np.asarray(a)
            if a.shape[0] != cfg.num_groups:
                raise ValueError(f"groups[{slot}].{n}: leading axis "
                                 f"{a.shape[0]} != {cfg.num_groups} groups")
            for g in range(cfg.num_groups):
                sd[f"layers.{g * G + slot}.{n}"] = _tensor_from_numpy(a[g])
    return sd


def params_to_numpy(cfg, state_dict) -> Dict:
    """The reference's parameter pytree (numpy leaves, layers stacked per
    group slot) from a port ``state_dict``."""
    def nest(items):
        out: Dict = {}
        for name, leaf in items:
            *path, last = name.split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[last] = leaf
        return out

    host = {k: _numpy_from_tensor(v) for k, v in state_dict.items()}
    G = cfg.group_size
    groups = []
    for slot in range(G):
        names = sorted({k.split(".", 2)[2] for k in host
                        if k.startswith(f"layers.{slot}.")})
        groups.append(nest(
            (n, np.stack([host[f"layers.{g * G + slot}.{n}"]
                          for g in range(cfg.num_groups)]))
            for n in names))
    return {"embed": nest((k[len("embed."):], v) for k, v in host.items()
                          if k.startswith("embed.")),
            "groups": groups,
            "final_norm": nest((k[len("final_norm."):], v)
                               for k, v in host.items()
                               if k.startswith("final_norm."))}
