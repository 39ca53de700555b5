"""Activation-sharding hints, mesh-agnostic.

Model code runs unchanged without a mesh (every CPU test). Under
:func:`use_hints` (set by the caller of a sharded step, with the rules of
``launch/sharding.py``), ``hint(x, *logical_axes)`` redistributes a
DTensor ``x`` to the placements its logical dim names map to: the port's
``with_sharding_constraint``. The reference pins activations where
GSPMD's propagation chooses badly (MoE routing and dispatch, the SSM
projections, the residual stream of each group); DTensor propagates
placements op by op, and the same calls fix the same layouts.

A *spec* is the reference's ``PartitionSpec`` as a tuple, one entry per
tensor dim: ``None`` (unsharded), a mesh-dim name, or a tuple of names
(the dim split over several mesh dims, the first outermost).
:func:`placements_from_spec` turns it into one DTensor placement per
mesh dim: ``Shard(d)`` on every mesh dim that splits tensor dim ``d``,
``Replicate()`` on the rest. DTensor splits a dim over several mesh dims
in mesh order, so a multi-axis entry must list its names in mesh order.

A mesh built by ``launch/mesh.arch_mesh`` leaves out its size-1
sub-dims; a spec naming one of :data:`MESH_DIMS` that the mesh lacks
splits nothing on it.

A plain tensor, or any tensor outside a context, passes through
unchanged: unsharded results do not move by a bit.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

Spec = Tuple[Any, ...]
#: every mesh-dim name a rule may use; one a mesh lacks has size 1
MESH_DIMS = ("pod", "data", "tp_kv", "tp_g", "tp_r")


class _Hints(NamedTuple):
    mesh: Any
    rules: Dict[str, Any]
    param_rules: Optional[Dict[str, Any]]


#: the hint contexts entered, innermost last. A process-wide stack, not a
#: context variable: a CUDA backward (and the recompute of a checkpointed
#: group in it) runs on the autograd engine's own thread, which sees no
#: context variable of the caller's
_STACK: List[_Hints] = []


@contextlib.contextmanager
def use_hints(mesh, rules: Dict[str, Any],
              param_rules: Optional[Dict[str, Any]] = None):
    """Hint activations on ``mesh`` by ``rules`` (logical name → mesh-dim
    names). ``param_rules``, when set, re-places each group's parameters
    at the top of its body (:func:`param_hint_tree`): with TP-only rules
    that all-gathers FSDP-sharded weights once a layer."""
    _STACK.append(_Hints(mesh, rules, param_rules))
    try:
        yield
    finally:
        _STACK.pop()


def active() -> Optional[_Hints]:
    """The current ``(mesh, rules, param_rules)``, or None."""
    return _STACK[-1] if _STACK else None


def spec_from_axes(axes, rules: Dict[str, Any]) -> Spec:
    """One tensor's logical dim names → its spec. A mesh dim appears once
    per spec and earlier dims win (MoE ``(experts, embed, ffn)``: the
    experts take the model dims, the per-expert ffn dim stays local)."""
    parts = []
    used = set()
    for ax in axes:
        r = rules.get(ax) if ax is not None else None
        if r is None:
            parts.append(None)
            continue
        r = r if isinstance(r, tuple) else (r,)
        r = tuple(a for a in r if a not in used)
        used.update(r)
        parts.append(None if not r else (r[0] if len(r) == 1 else r))
    return tuple(parts)


def placements_from_spec(mesh, spec: Spec) -> tuple:
    """``spec`` on ``mesh`` → one placement per mesh dim."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a in names:
                idx.append(names.index(a))
            elif a not in MESH_DIMS:
                raise ValueError(f"spec {spec}: {a!r} is not a dim of the "
                                 f"mesh {tuple(names)}")
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} lists {axes}, not in "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def placements_for(mesh, rules: Dict[str, Any], logical_axes) -> tuple:
    return placements_from_spec(mesh, spec_from_axes(logical_axes, rules))


def _place(x, mesh, want):
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def hint(x, *logical_axes):
    """Constrain a DTensor's placements by logical dim names (None =
    unsharded); the identity on a plain tensor and outside a context. A
    dim its mesh dims do not divide (long_500k's batch of 1 over 16) stays
    whole: GSPMD would pad it, and a local region's output would take the
    padded size for the global one."""
    ctx = active()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return _place(x, ctx.mesh, fitting(
        x.shape, ctx.mesh, placements_for(ctx.mesh, ctx.rules, logical_axes)))


def fitting(shape, mesh, placements) -> tuple:
    """``placements`` with every split of a dim its mesh dims do not
    divide dropped (that dim stays whole)."""
    ways = {}
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            ways[pl.dim] = ways.get(pl.dim, 1) * mesh.size(i)
    return tuple(Replicate() if isinstance(pl, Shard)
                 and shape[pl.dim] % ways[pl.dim] else pl
                 for pl in placements)


def param_hint_tree(params: Dict[str, Any], axes: Dict[str, tuple]
                    ) -> Dict[str, Any]:
    """Re-place a group's parameters (``name → tensor``, ``axes`` keyed
    alike) by the context's ``param_rules``; ``params`` unchanged unless
    the context carries param rules."""
    ctx = active()
    if ctx is None or ctx.param_rules is None:
        return params
    return {k: (_regather(p, ctx.mesh, placements_for(ctx.mesh,
                                                      ctx.param_rules,
                                                      axes[k]))
                if isinstance(p, DTensor) else p)
            for k, p in params.items()}


def _regather(p, mesh, want):
    """``p`` re-placed at ``want``; the copy remembers ``p`` so that a
    product's f32 weight gradient (:func:`f32_grad_operand`) is summed
    onto p's own placements (a reduce-scatter onto an FSDP shard), not
    onto the copy's."""
    t = _place(p, mesh, want)
    if t is not p:
        t._regathered_from = p
    return t


def column_parallel(fn, x, w, f32_grad: bool = False):
    """``fn(x, w)``, a product contracting x's last dim with w's first, on
    each rank's shard of w's other dims: x whole on its last dim, w whole
    on its first (an FSDP split there is gathered); the result keeps x's
    leading splits and splits w's other dims as w does (DTensor's own
    reshape of a dim split over two mesh dims is not to be trusted). With
    ``f32_grad``, ``fn(x, w, grad_to)`` (:func:`_run_product`)."""
    xp, wp, yp = [], [], []
    for a, b in zip(x.placements, w.placements):
        a = a if isinstance(a, Shard) and a.dim < x.ndim - 1 else Replicate()
        b = b if (isinstance(b, Shard) and b.dim > 0
                  and not isinstance(a, Shard)) else Replicate()
        xp.append(a)
        wp.append(b)
        yp.append(a if isinstance(a, Shard) else
                  Shard(x.ndim + b.dim - 2) if isinstance(b, Shard)
                  else Replicate())
    return _run_product(fn, yp, xp, wp, x, w, f32_grad)


def _run_product(fn, yp, xp, wp, x, w, f32_grad: bool):
    """``fn(x, w)`` on local shards; with ``f32_grad``, ``fn(x, w,
    grad_to)``, where the product hands w's f32 gradient (see
    :func:`f32_grad_operand`). Where w is whole on every mesh dim that
    splits its gradient into partial sums, ``grad_to`` sums it there in
    f32 inside the local backward (one all-reduce a dim, which a
    ``Partial`` gradient would cost anyway), before autograd casts it
    to w's type; elsewhere (an FSDP shard, a re-placed copy) it is a
    carrier, whose gradient DTensor sums onto w's own placements (a
    reduce-scatter onto an FSDP shard)."""
    mesh = w.device_mesh
    if not f32_grad:
        return run_local(fn, mesh, yp, (xp, wp), x, w)
    split = [i for i in range(len(wp))
             if wp[i] == Replicate() and isinstance(xp[i], Shard)]
    if getattr(w, "_regathered_from", None) is None and all(
            w.placements[i] == Replicate() for i in split):
        red = functools.partial(_sum_over, mesh, split)
        return run_local(lambda a, b: fn(a, b, red), mesh, yp, (xp, wp),
                         x, w, grad_placements=(None, wp))
    w, carrier = f32_grad_operand(w, tuple(wp))
    return run_local(fn, mesh, yp, (xp, wp, wp), x, w, carrier)


def _sum_over(mesh, dims, t: torch.Tensor) -> torch.Tensor:
    """A local tensor summed over the ranks of each of ``mesh``'s
    ``dims`` in its own type, one dim at a time (as DTensor reduces a
    ``Partial``)."""
    for i in dims:               # waited on where it is next used
        t = funcol.all_reduce(t, "sum", (mesh, i))
    return t


def row_parallel(fn, x, w, reduce_to=None, f32_grad: bool = False):
    """``fn(x, w)``, a product contracting x's trailing dims with all of
    w's but its last, on each rank's shard of the first contracted dim:
    where x and w split it over the same mesh dims the result is a
    partial sum there (Megatron's row-parallel half); any other split of
    w is gathered, x's leading splits are kept. With ``reduce_to`` (a
    dtype) the partial sums are reduced at once, in ``fn``'s result type,
    and the sum is cast to it: DTensor casts a ``Partial`` tensor
    partial by partial, which would sum the rounded partials. With
    ``f32_grad``, ``fn(x, w, grad_to)`` (:func:`_run_product`)."""
    first = x.ndim - (w.ndim - 1)
    xp, wp, yp = [], [], []
    for a, b in zip(x.placements, w.placements):
        rows = a == Shard(first) and b == Shard(0)
        a = a if rows or (isinstance(a, Shard) and a.dim < first) \
            else Replicate()
        xp.append(a)
        wp.append(b if rows else Replicate())
        yp.append(Partial() if rows else a)
    y = _run_product(fn, yp, xp, wp, x, w, f32_grad)
    if reduce_to is None:
        return y
    return _reduced(y).to(reduce_to)


def _reduced(t: DTensor) -> DTensor:
    """``t`` with every ``Partial`` placement summed (``Replicate``)."""
    if not any(isinstance(pl, Partial) for pl in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if isinstance(pl, Partial) else pl
        for pl in t.placements))


class _GradInF32(torch.autograd.Function):
    """x (or ``use``, a re-placed copy of it) widened to f32; its gradient
    summed where it is partial, in f32, then cast to x's type once. With
    ``own``, summed onto x's own placements (a weight: an all-reduce
    where x is whole, a reduce-scatter where FSDP splits it)."""

    @staticmethod
    def forward(ctx, x, own=False, use=None):
        ctx.dtype = x.dtype
        ctx.own = (x.device_mesh, tuple(x.placements)) if own else None
        return (x if use is None else use).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            g = _reduced(g) if ctx.own is None else g.redistribute(*ctx.own)
        return g.to(ctx.dtype), None, None


def grad_in_f32(x):
    """A DTensor ``x`` of a lower type than f32, which a column-parallel
    product will contract with weights split where x is whole: x widened
    to f32 (it holds the same values), so that each rank's share of x's
    gradient stays an f32 result and the shares are summed in f32 and cast
    once, as the reference sums the transpose of an f32-result einsum.
    The products take the widened x as the weights' type. Any other x,
    or x needing no gradient, is returned as it is."""
    if not wants_f32_grad(x):
        return x
    return _GradInF32.apply(x)


def wants_f32_grad(t) -> bool:
    """Whether ``t`` is a DTensor of a lower type than f32 whose gradient
    this pass computes: one the reference sums in f32 where it is
    partial, and casts once."""
    return (isinstance(t, DTensor) and t.dtype != torch.float32
            and torch.is_grad_enabled() and t.requires_grad)


def weight_in_f32(w):
    """``w.to(f32)``, for a weight the reference widens before use (a
    norm scale, the SSM's ``wdt``): with a DTensor weight that needs a
    gradient, that gradient is summed onto w's placements in f32 and
    cast once (DTensor casts a ``Partial`` gradient partial by partial);
    a :func:`param_hint_tree` copy's onto its parameter's."""
    if not wants_f32_grad(w):
        return w.to(torch.float32)
    src = getattr(w, "_regathered_from", None)
    if src is None:
        return _GradInF32.apply(w, True)
    return _GradInF32.apply(src, True, w.detach())


class _F32Carrier(torch.autograd.Function):
    """An f32 tensor of ``use``'s shape and placements that allocates one
    element (every stride 0): a local product of ``use`` hands its f32
    weight gradient to it, and its backward sums that onto ``w``'s own
    placements in f32, then casts it to w's type once."""

    @staticmethod
    def forward(ctx, w, use):
        ctx.own = (w.device_mesh, tuple(w.placements))
        ctx.dtype = w.dtype
        loc = use.to_local()
        # its values are never read: one element, every stride 0
        zero = torch.empty_strided(loc.shape, (0,) * loc.ndim,
                                   dtype=torch.float32, device=loc.device)
        return DTensor.from_local(zero, use.device_mesh, use.placements,
                                  run_check=False, shape=use.shape,
                                  stride=use.stride())

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.own).to(ctx.dtype), None


def f32_grad_operand(w, placements):
    """A product weight ``w`` (a DTensor of a lower type than f32) →
    ``(w at placements, carrying no gradient; its carrier)``. The
    reference's weight gradient is the transpose of an f32-result
    product: an f32 result, its data-parallel partials summed in f32
    (GSPMD reduces the dot's result before its cast), cast to w's type
    after. Autograd casts a gradient to its input's type where it leaves
    a node, so the local product gives the f32 result to the carrier (an
    f32 input, :class:`_F32Carrier`), which sums it onto w's placements
    and casts it once. No f32 copy of w is made, kept or saved. A copy
    that :func:`param_hint_tree` re-placed hands the gradient on to the
    parameter it came from."""
    src = getattr(w, "_regathered_from", w)
    with torch.no_grad():
        use = _place(w.detach(), w.device_mesh, tuple(placements))
    return use, _F32Carrier.apply(src, use)


def run_local(fn, mesh, out_placements, in_placements, *args,
              grad_placements=None):
    """``fn(*args)`` on each rank's local shards (``local_map``): every
    DTensor argument is first redistributed to its ``in_placements``
    entry (None for the other arguments), the result takes
    ``out_placements`` (a tuple of them for a tuple of results). Each rank's gradient of an argument it holds
    whole on a mesh dim that another argument splits covers only that
    rank's part of the work: it is ``Partial`` there, unless a
    ``grad_placements`` entry (None: as said) gives its placements (fn's
    backward summed it already)."""
    dims = range(len(mesh.mesh_dim_names))

    def grad_pl(pl, given=None):
        if pl is None or given is not None:
            return given
        return tuple(
            Partial() if pl[i] == Replicate() and any(
                o is not None and isinstance(o[i], Shard)
                for o in in_placements) else pl[i]
            for i in dims)

    outs = (tuple(tuple(o) for o in out_placements)
            if isinstance(out_placements[0], (tuple, list))
            else (tuple(out_placements),))
    given = grad_placements or (None,) * len(in_placements)
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(in_placements),
                     in_grad_placements=tuple(
                         grad_pl(p, g) for p, g in zip(in_placements, given)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
