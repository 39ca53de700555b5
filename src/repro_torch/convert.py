"""Carry a device table's state between the reference package and this one.

The reference keeps its ``DeviceTableState`` as JAX arrays; mapping it to
numpy (``jax.tree.map(np.asarray, state)``) gives a record of numpy
arrays with the same field names. :func:`state_from_numpy` takes that
record (or the dict :func:`state_to_numpy` returns) onto a device;
:func:`state_to_numpy` brings a port state back as a dict of numpy
arrays, ``stats`` a dict of 0-d int32 arrays. Filter words are uint32 on
the reference side and int32 with the same bits here: the ``.view`` at
this boundary is the only conversion.
"""
from __future__ import annotations

from typing import Dict

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
