"""Atomic, asynchronous checkpoints of array trees: store snapshots and
train states.

Layout (the reference package's): ``<dir>/step_<N>/{meta.json,
arrays.npz}``, with ``N`` zero-padded to eight digits. A checkpoint is
written to ``step_<N>.tmp`` and then renamed, so a crashed writer never
leaves a half-written ``step_<N>``. ``meta.json`` carries ``step``,
``time``, ``keys`` (the sorted array names), ``dtypes`` and
``data_state`` (the loader is stateless given the step), plus the
caller's extra entries.

A tree is a nest of dicts, lists / tuples and NamedTuples whose leaves
are tensors, numpy arrays or scalars. It flattens with ``/`` between the
levels (:func:`flatten`: dict keys, list indices, NamedTuple field
names), which gives the names the reference writes: a table state from
``convert.state_to_numpy`` (``keys``, ..., ``stats/tile_stores``) or a
train state (``params/groups/0/mixer/wq``, ``opt/m/...``, ``opt/count``),
so a checkpoint written by either package loads in the other. A bf16
leaf is stored as its uint16 bit pattern with ``"bfloat16"`` in
``dtypes`` (numpy has no bf16 without ``ml_dtypes``) and comes back as a
bf16 tensor.

An object that owns its tensors (the trainer's
:class:`~repro_torch.launch.steps.TrainState`) stands in a tree through
two methods: ``checkpoint_tree()`` returns its host tree in the saved
layout, and ``load_checkpoint_tree(tree)`` takes one back (leaves as CPU
tensors) and returns the object, loaded in place.

:class:`CheckpointManager` saves every ``every_steps`` steps on a writer
thread: the device→host copy runs on the caller's thread first, so the
next step cannot race the write. It keeps the newest ``keep``
checkpoints, runs registered ``quiesce`` barriers (``FlashStore.quiesce``)
before every save, and makes best-effort ``emergency`` saves.
"""
from __future__ import annotations

import json
import shutil
# the async checkpoint writer owns its own (single) writer thread, as the
# reference's does; an audited exception to the one-worker-pool rule
import threading  # flashlint: disable=FL004
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``(name, child)`` pairs of an inner node, or None for a leaf."""
    if hasattr(node, "checkpoint_tree"):
        node = node.checkpoint_tree()
    if isinstance(node, dict):
        return node.items()
    if _is_namedtuple(node):
        return zip(node._fields, node)
    if isinstance(node, (list, tuple)):
        return ((str(i), c) for i, c in enumerate(node))
    return None


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """``{"a": x, "b": {"c": y}, "d": [z]}`` → ``{"a": x, "b/c": y,
    "d/0": z}``. Tensor leaves stay tensors; others become numpy."""
    out: Dict[str, object] = {}
    kids = _children(tree)
    if kids is None:
        return {prefix.rstrip("/"): tree if isinstance(tree, torch.Tensor)
                else np.asarray(tree)}
    for k, v in kids:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def unflatten(flat: Dict[str, object]) -> Dict:
    """The inverse of :func:`flatten` for dicts (lists come back as dicts
    keyed ``"0"``, ``"1"``, ...)."""
    out: Dict = {}
    for name, v in flat.items():
        *path, last = name.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """``(numpy array as stored, dtype name)``; bf16 (or another dtype
    numpy lacks) as its bit pattern. A DTensor is gathered whole."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), \
                "bfloat16"
        return t.numpy().copy(), str(t.numpy().dtype)
    a = np.asarray(leaf)
    if a.dtype.kind not in "biufc":  # ml_dtypes (bfloat16, fp8, ...)
        bits = a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint8)
        return bits, str(a.dtype)
    return a, str(a.dtype)


def host_arrays(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """The device→host copy of ``tree``: ``(arrays, dtypes)`` by name."""
    arrays, dtypes = {}, {}
    for k, v in flatten(tree).items():
        arrays[k], dtypes[k] = _to_host(v)
    return arrays, dtypes


def _step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:08d}"


def _write(ckpt_dir, step: int, arrays: Dict[str, np.ndarray],
           dtypes: Dict[str, str], extra_meta: Optional[dict]) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = _step_dir(ckpt_dir, step)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": step, "time": time.time(), "keys": sorted(arrays),
            "dtypes": dtypes, "data_state": {"step": step}}
    meta.update(extra_meta or {})
    (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return final


def save_checkpoint(ckpt_dir, step: int, tree,
                    extra_meta: Optional[dict] = None) -> Path:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``,
    atomically; returns its directory."""
    arrays, dtypes = host_arrays(tree)
    return _write(ckpt_dir, step, arrays, dtypes, extra_meta)


def latest_step(ckpt_dir) -> Optional[int]:
    """The highest complete ``step_<N>`` under ``ckpt_dir`` (None when
    there is none)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _as_tensor(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A CPU tensor of a stored array, bf16 restored from its bits."""
    if dtype_name == "bfloat16" and a.dtype.kind in "ui":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _fill(target, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
          prefix: str, placed=None):
    """``target``'s structure rebuilt from ``flat`` (names under
    ``prefix``); each leaf in its target's type and place, or
    distributed on ``placed[name]`` (``(mesh, placements)``)."""
    if hasattr(target, "load_checkpoint_tree"):
        pre = prefix
        sub = {k[len(pre):]: _as_tensor(v, dtypes.get(k))
               for k, v in flat.items() if k.startswith(pre)}
        return target.load_checkpoint_tree(_lists(unflatten(sub)))
    kids = _children(target)
    if kids is not None:
        got = {k: _fill(v, flat, dtypes, f"{prefix}{k}/", placed)
               for k, v in kids}
        if isinstance(target, dict):
            return got
        if _is_namedtuple(target):
            return type(target)(**got)
        return type(target)(got[str(i)] for i in range(len(target)))
    key = prefix.rstrip("/")
    if key not in flat:
        raise KeyError(f"checkpoint missing key {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(np.shape(target)):
        raise ValueError(f"{key}: shape {arr.shape} != {np.shape(target)}")
    if isinstance(target, torch.Tensor):
        t = _as_tensor(arr, dtypes.get(key)).to(dtype=target.dtype,
                                                 device=target.device)
        if placed and key in placed:
            return distribute_tensor(t, *placed[key])
        return t
    return np.asarray(arr).astype(np.asarray(target).dtype)


def _lists(tree):
    """Dicts keyed ``"0"``..``"n-1"`` back into lists (the groups)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out) and \
            sorted(int(k) for k in out) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def restore_checkpoint(ckpt_dir, target=None, step: Optional[int] = None,
                       placements: Optional[Dict[str, tuple]] = None):
    """Checkpoint ``step`` (the latest by default) → ``(tree, meta)``.

    With ``target`` the tree has ``target``'s structure, each leaf cast to
    its target's dtype (and device, for a tensor); a missing name raises
    ``KeyError``, a different shape ``ValueError``. Without it, the tree
    is the flat dict of the arrays as stored. ``placements`` (leaf name,
    as :func:`flatten` names it → ``(mesh, placements)``) restores those
    leaves as DTensors on their target placements: the elastic reshard,
    onto whatever mesh the placements name."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    meta = json.loads((d / "meta.json").read_text())
    with np.load(d / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    if target is None:
        return arrays, meta
    return _fill(target, arrays, meta.get("dtypes", {}), "",
                 placements), meta


class CheckpointManager:
    """Periodic asynchronous checkpoints, retention and emergency saves.

    ``quiesce`` callables (``FlashStore.quiesce``) run before every save,
    so a checkpoint never captures a store whose background drain is
    mid-flight."""

    def __init__(self, ckpt_dir, every_steps: int = 100, keep: int = 3,
                 quiesce=()):
        self.dir = Path(ckpt_dir)
        self.every = every_steps
        self.keep = keep
        self._quiesce: List[Callable[[], None]] = list(quiesce)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def register_quiesce(self, fn) -> None:
        """Add a barrier to run before every save (once per ``fn``)."""
        if fn not in self._quiesce:
            self._quiesce.append(fn)

    def _join_quiesce(self, best_effort: bool = False) -> None:
        for fn in self._quiesce:
            try:
                fn()
            except Exception:
                if not best_effort:
                    raise         # an emergency save swallows: the store
                    #               may be poisoned mid-crash

    def maybe_save(self, step: int, tree, blocking: bool = False,
                   extra_meta: Optional[dict] = None) -> bool:
        if step % self.every != 0:
            return False
        self.save(step, tree, blocking=blocking, extra_meta=extra_meta)
        return True

    def save(self, step: int, tree, blocking: bool = False,
             extra_meta: Optional[dict] = None) -> Path:
        """Checkpoint ``tree`` as ``step``; returns its directory (written
        by the time :meth:`wait` returns unless ``blocking``)."""
        self.wait()
        self._join_quiesce()          # no mid-drain state in the copy
        # the device→host copy happens here, so the step cannot race it
        arrays, dtypes = host_arrays(tree)

        def work():
            try:
                _write(self.dir, step, arrays, dtypes, extra_meta)
                self._gc()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self.last_saved = step
        if blocking:
            work()
            self._raise()
        else:
            self._thread = threading.Thread(target=work, daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()
        return _step_dir(self.dir, step)

    def emergency(self, step: int, tree) -> None:
        """Blocking best-effort save on failure paths. The quiesce barriers
        run first, best effort (a poisoned store must not veto saving the
        rest)."""
        try:
            self.wait()
            self._join_quiesce(best_effort=True)
            save_checkpoint(self.dir, step, tree, {"emergency": True})
        except Exception:
            pass

    def wait(self) -> None:
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        self._raise()

    def _raise(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)


__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "CheckpointManager", "flatten", "unflatten", "host_arrays"]
