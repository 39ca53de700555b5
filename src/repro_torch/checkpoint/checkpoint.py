"""Atomic snapshots of named numpy arrays: what a store snapshot needs.

Layout (the reference package's): ``<dir>/step_<N>/{meta.json,
arrays.npz}``, with ``N`` zero-padded to eight digits. A snapshot is
written to ``step_<N>.tmp`` and then renamed, so a crashed writer never
leaves a half-written ``step_<N>``. ``meta.json`` carries ``step``,
``time``, ``keys`` (the sorted array names), ``dtypes`` and
``data_state``, plus the caller's extra entries.

Arrays are a flat dict. A nested record (a table state from
``convert.state_to_numpy``, whose ``stats`` is a dict) flattens with
``/`` between the levels (:func:`flatten`), which gives the names the
reference writes for its ``DeviceTableState`` (``keys``, ...,
``stats/tile_stores``): a snapshot written by either package loads in
the other.

The periodic, asynchronous ``CheckpointManager`` of the reference comes
with the training slice of the port.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a": x, "b": {"c": y}}`` -> ``{"a": x, "b/c": y}`` (numpy)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """The inverse of :func:`flatten`."""
    out: Dict = {}
    for name, v in flat.items():
        *path, last = name.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def _step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:08d}"


def save_checkpoint(ckpt_dir, step: int, arrays: Dict[str, np.ndarray],
                    extra_meta: Optional[dict] = None) -> Path:
    """Write ``arrays`` (name -> numpy array) as snapshot ``step`` under
    ``ckpt_dir``, atomically; returns its directory."""
    ckpt_dir = Path(ckpt_dir)
    final = _step_dir(ckpt_dir, step)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": step, "time": time.time(),
            "keys": sorted(arrays), "dtypes": {k: str(a.dtype)
                                               for k, a in arrays.items()},
            "data_state": {"step": step}}
    meta.update(extra_meta or {})
    (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    """The highest complete ``step_<N>`` under ``ckpt_dir`` (None when
    there is none)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, step: Optional[int] = None
                       ) -> Tuple[Dict[str, np.ndarray], dict]:
    """``(arrays, meta)`` of snapshot ``step`` (the latest by default)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    meta = json.loads((d / "meta.json").read_text())
    with np.load(d / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, meta


__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "flatten", "unflatten"]
