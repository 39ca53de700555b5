"""Per-device roofline terms of a sharded step, from the ops it runs.

The counterpart of the reference's ``launch/hlo_analysis.py``. There is
no HLO here: a sharded step in PyTorch is a program of DTensor ops that
DTensor turns, rank by rank, into local ops and ``_c10d_functional``
collectives. :class:`OpCounter` is a ``TorchDispatchMode`` that lets
each DTensor op through to DTensor's own dispatch and counts the local
ops and collectives that come out of it: rank 0's program, the per-device
program of the reference's HLO. Run over fake tensors on a fake process
group (``dryrun.py``) it allocates nothing; run over real tensors it
counts the same program (``chip_smoke.py`` holds the two equal).

Per device:

* ``dot_flops`` — matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``; an
  einsum lowers to them), by ``torch.utils.flop_counter``'s formulas,
  plus a flash-attention launch as the dense attention it computes
  (2·b·h·s·t·(d + dv)): a ctypes launch is no aten op, so the wrapper
  reports it (``kernels/flash_attn/kernel.NOTE``);
* ``hbm_bytes_upper`` — operands + result of every op that is not a
  view (no fusion credit: the reference's one-op-per-fusion view);
* ``hbm_bytes_flashproj`` — that minus the traffic of ``(…, S, S)`` score
  tensors (and the other layouts an einsum's batched products give
  them) when ``seq_len`` is given, and of every tensor a flash-attention
  kernel's dense stand-in allocates (``kernel.STANDIN``): the bytes left
  when attention runs as the fused kernel, whose score tiles never reach
  memory;
* ``collectives`` — operand bytes and counts by kind (``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``, ...), and each
  kind's bytes by operand type (``by_dtype``: ``{"float32": n,
  "bfloat16": n, ...}``), which tells an f32 reduction from a bf16 one;
* ``peak_bytes`` / ``peak_bytes_flashproj`` — the peak of live tensor
  storage (fake or real) over the run, from allocations the counter
  sees plus the ``initial`` trees (parameters, moments, caches, batch),
  and the same without score tensors;
* ``ops_traced`` — the local ops counted (``hlo_lines``' stand-in).

With a ``listing`` list the counter also appends one line for each op
it counts, in order (the dry-run's ``--save-hlo``): the op, its local
operand and result types and shapes, its dot FLOPs and bytes as counted
above, and for a collective its kind and group size; a flash-attention
launch as its wrapper notes it.

DTensor computes each op's global output shape by running it on fake
tensors first (``ShardingPropagator._propagate_tensor_meta_non_cached``);
while a counter is active that method is wrapped so those global-shape
ops are not counted.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable

import torch
import torch.distributed.distributed_c10d as dist_c10d
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels.flash_attn import kernel as flash_kernel

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
_KIND = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
         ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
         ("permute", "collective-permute"), ("broadcast", "broadcast"))
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias",
               "_unsafe_view", "lift_fresh", "wait_tensor", "new_empty",
               "new_empty_strided", "set_", "resize_"}
_TRANSCENDENTAL = {"exp", "tanh", "sigmoid", "rsqrt", "log", "pow", "sin",
                   "cos", "silu", "gelu", "_softmax", "_log_softmax",
                   "softplus", "sqrt"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


_SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
          "float64": "f64", "int64": "s64", "int32": "s32", "int16": "s16",
          "int8": "s8", "uint8": "u8", "bool": "pred"}


def _sig(ts) -> str:
    """``bf16[2,64]`` for each tensor, comma-separated."""
    out = []
    for t in ts:
        dt = str(t.dtype).removeprefix("torch.")
        out.append(f"{_SHORT.get(dt, dt)}[{','.join(map(str, t.shape))}]")
    return ", ".join(out)


def _group_size(func, args, kwargs):
    """The size of a functional collective's process group, or None."""
    names = [a.name for a in func._schema.arguments]
    if "group_name" not in names:
        return None
    i = names.index("group_name")
    name = kwargs.get("group_name", args[i] if i < len(args) else None)
    try:
        return dist_c10d._resolve_process_group(name).size()
    except (RuntimeError, ValueError, TypeError):
        return None


class OpCounter(TorchDispatchMode):
    """Count rank 0's local ops while active (see the module docstring).
    ``seq_len`` names the score tensors' ``(S, S)`` tail; ``initial``
    holds the trees that are live before the run (their storage counts
    toward the peaks); ``listing``, a list, takes one line an op."""

    def __init__(self, seq_len: int = 0, initial=(), listing=None):
        super().__init__()
        self.seq_len = seq_len
        self.listing = listing
        self.dot_flops = 0
        self.hbm_bytes_upper = 0
        self.score_bytes = 0
        self.transcendentals = 0
        self.ops_traced = 0
        self.collectives = {k: {"bytes": 0, "count": 0, "by_dtype": {}}
                            for k in COLLECTIVES}
        self._live: Dict[int, int] = {}
        self._scores: Dict[int, int] = {}
        self._live_bytes = self._score_live = 0
        self.peak_bytes = self.peak_bytes_flashproj = 0
        self._propagating = 0
        self._patched = None
        self._note_token = None
        for t in _tensors(initial):
            self._track(_local(t))

    # -- live storage ---------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        if self._is_score(t) or flash_kernel.STANDIN.get():
            self._scores[key] = n
            self._score_live += n
        weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        self.peak_bytes_flashproj = max(self.peak_bytes_flashproj,
                                        self._live_bytes - self._score_live)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)
        self._score_live -= self._scores.pop(key, 0)

    def _scored(self, t: torch.Tensor) -> bool:
        """A score tensor by its shape, or one a kernel's dense stand-in
        allocated."""
        if self._is_score(t):
            return True
        try:
            return t.untyped_storage()._cdata in self._scores
        except (NotImplementedError, RuntimeError):
            return False

    def _is_score(self, t: torch.Tensor) -> bool:
        """``(…, S, S)``, or a layout an einsum's batched product makes of
        it (``(…, g·S, S)``, two dims of S anywhere)."""
        s = self.seq_len
        return s > 1 and (sum(d == s for d in t.shape) >= 2 or (
            t.dim() >= 2 and t.shape[-1] == s and t.shape[-2] % s == 0
            and t.shape[-2] > 0))

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._propagating:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        outs = list(_tensors(out))
        if not outs:
            return
        name = func.__name__.split(".")[0]
        self.ops_traced += 1
        # an ``out=`` tensor is the result, counted once
        ins = list(_tensors((args, {k: v for k, v in kwargs.items()
                                    if k != "out"})))
        note = ""
        if func.namespace == "_c10d_functional":
            kind = next((k for frag, k in _KIND if frag in name), None)
            if kind is not None:
                c = self.collectives[kind]
                c["bytes"] += sum(_nbytes(t) for t in ins)
                c["count"] += 1
                for t in ins:
                    dt = str(t.dtype).removeprefix("torch.")
                    c["by_dtype"][dt] = c["by_dtype"].get(dt, 0) + _nbytes(t)
                note = f"\t{kind} group={_group_size(func, args, kwargs)}"
        flops = moved = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.dot_flops += flops
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if func.is_view or name in _NO_TRAFFIC:
            if name.startswith("empty") or name.startswith("new_empty"):
                for t in outs:
                    self._track(t)
        else:
            both = ins + outs
            moved = sum(_nbytes(t) for t in both)
            self.hbm_bytes_upper += moved
            for t in outs:
                self._track(t)
            self.score_bytes += sum(_nbytes(t) for t in both
                                    if self._scored(t))
        if self.listing is not None:
            self.listing.append(f"{func}\t{_sig(ins)} -> {_sig(outs)}"
                                f"\tflops={flops}\tbytes={moved}{note}")

    def _note_flash(self, q, k, v, causal, window) -> None:
        """A flash-attention launch, as the dense attention it computes
        (the reference's count, whatever its mask or window keeps)."""
        b, s, h, d = q.shape
        t, dv = k.shape[1], v.shape[3]
        flops = 2 * b * h * s * t * (d + dv)
        self.dot_flops += flops
        self.ops_traced += 1
        o_bytes = b * s * h * dv * v.element_size()
        moved = sum(_nbytes(x) for x in (q, k, v)) + o_bytes
        self.hbm_bytes_upper += moved
        if self.listing is not None:
            out = _sig([q]).split("[")[0] + f"[{b},{s},{h},{dv}]"
            self.listing.append(
                f"flash_attention_fwd(causal={causal}, window={window})"
                f"\t{_sig((q, k, v))} -> {out}\tflops={flops}"
                f"\tbytes={moved}")

    # -- entering / leaving -----------------------------------------------
    def __enter__(self):
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop, op_schema):
            counter._propagating += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._propagating -= 1

        self._patched = orig
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._note_token = flash_kernel.NOTE.set(self._note_flash)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = \
                self._patched
            flash_kernel.NOTE.reset(self._note_token)

    def summary(self) -> dict:
        total = sum(c["bytes"] for c in self.collectives.values())
        return {
            "dot_flops": int(self.dot_flops),
            "hbm_bytes_upper": int(self.hbm_bytes_upper),
            "hbm_bytes_flashproj": int(self.hbm_bytes_upper
                                       - self.score_bytes),
            "score_bytes": int(self.score_bytes),
            "transcendentals": int(self.transcendentals),
            "collectives": dict({k: dict(v, by_dtype=dict(v["by_dtype"]))
                                 for k, v in self.collectives.items()},
                                total_bytes=int(total)),
            "peak_bytes": int(self.peak_bytes),
            "peak_bytes_flashproj": int(self.peak_bytes_flashproj),
            "ops_traced": int(self.ops_traced),
        }


def count(fn, seq_len: int = 0, initial=(), listing=None) -> dict:
    """Run ``fn()`` under an :class:`OpCounter` → its summary (and its
    op lines appended to ``listing``, if given)."""
    counter = OpCounter(seq_len, initial, listing)
    with counter:
        fn()
    return counter.summary()


def combine(*terms) -> dict:
    """``Σ coef · summary`` over ``(coef, summary)`` pairs of (nested)
    summaries; a key one of them lacks (a dtype in ``by_dtype``) counts
    0 there."""
    def go(vals):
        dicts = [v for _, v in vals if isinstance(v, dict)]
        if dicts:
            keys = list(dict.fromkeys(k for d in dicts for k in d))
            return {k: go([(c, v.get(k, 0)) for c, v in vals])
                    for k in keys}
        v0 = vals[0][1]
        return type(v0)(sum(c * v for c, v in vals))
    return go(list(terms))


def weighted(at: dict, after: dict, groups: int, depth: int = 1) -> dict:
    """The summary of ``groups`` identical layer groups from the traces of
    ``depth`` groups and of ``depth + 1``: every count is linear in the
    group count (the reference's while-trip weighting), and so is the
    peak once the first group's transient is behind it (a trace of 2.11
    gave 4.13 / 4.58 / 4.63 GB at 1 / 2 / 3 groups of llama3.2-3b's
    prefill, the card 4.56 / 4.61 / 4.66), so the dry-run takes depth 2."""
    return combine((depth + 1 - groups, at), (groups - depth, after))
