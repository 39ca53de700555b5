"""Sharding rules: logical parameter / activation axes → DTensor
placements.

Every model module names the logical axis of each parameter dim
(``models.model.param_axes``); this module maps them onto the arch mesh
(``mesh.py``) under a :class:`ParallelPlan`, with the reference's rules:

* TP — ``vocab`` / ``ffn`` / ``experts`` / ``inner`` / ``conv_chan`` /
  ``ssm_heads`` shard over the whole model factoring (tp_kv·tp_g·tp_r);
  ``heads`` over (tp_kv, tp_g); ``kv_heads`` over tp_kv.
* FSDP — the ``embed`` dim of every parameter (and the AdamW moments,
  which take the parameters' placements) shards over ``data`` (and
  ``pod``) for the largest architectures.
* DP — ``batch`` over (``pod``,) ``data``; ``seq`` (the KV cache of a
  long-context decode whose batch cannot fill the data dim) over
  ``data``.

A spec (``sharding_hints.spec_from_axes``: a mesh dim once per spec,
earlier dims win) becomes one placement per mesh dim
(``sharding_hints.placements_from_spec``). The ``*_specs`` functions
return the specs and the ``*_shardings`` functions the placements, keyed
like the port's trees: ``state_dict`` names, the caches' slot tuples,
the batch's names.

Uneven dims: GSPMD pads a dim its mesh dims do not divide; DTensor
splits it into ``ceil``-sized chunks, the last ones short (or empty).
:func:`uneven` lists every such parameter; :func:`local_shape` gives a
rank's chunk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models import model as M
from ..models.config import ModelConfig, ShapeConfig
from ..models.sharding_hints import (Spec, placements_from_spec,
                                     spec_from_axes)
from .mesh import MODEL_AXIS, MeshPlan

__all__ = ["ParallelPlan", "logical_rules", "tp_only_rules",
           "spec_from_axes", "placements_from_spec", "tree_specs",
           "param_specs", "param_shardings", "cache_specs",
           "cache_shardings", "batch_specs", "batch_shardings",
           "replicated", "local_shape", "uneven", "distribute_model",
           "distribute_tree", "local_dtensor", "local_model", "local_tree"]


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Arch × shape parallelism settings."""

    fsdp: bool = False               # shard params over the data dim
    fsdp_pod: bool = False           # ... and over the pod dim too
    microbatches: int = 1            # grad-accumulation steps a train step
    seq_shard_decode: bool = True    # shard the KV seq dim when batch < DP


def data_parallel(plan: MeshPlan) -> int:
    """The production data-parallel width (the reference's ``dp``)."""
    return (2 if plan.multi_pod else 1) * 16


def _fsdp_axes(plan: MeshPlan, pp: ParallelPlan) -> Tuple[str, ...]:
    if not pp.fsdp:
        return ()
    return ("pod", "data") if (pp.fsdp_pod and plan.multi_pod) else ("data",)


def logical_rules(plan: MeshPlan, pp: ParallelPlan) -> Dict[str, Any]:
    fsdp = _fsdp_axes(plan, pp)
    return {
        "vocab": plan.tp_axes,
        "ffn": plan.tp_axes,
        "experts": plan.tp_axes,
        "inner": plan.tp_axes,
        "conv_chan": plan.tp_axes,
        "heads": plan.heads_axes,
        "kv_heads": ("tp_kv",),
        "ssm_heads": plan.tp_axes,
        "embed": fsdp if fsdp else None,
        "q_lora": None,
        "kv_lora": None,
        "kv_lora_rope": None,
        "head_dim": None,
        "layers": None,
        "batch": plan.batch_axes,
        "seq": None,   # set for long-context decode (cache_specs)
    }


def tp_only_rules(plan: MeshPlan) -> Dict[str, Any]:
    """The parameter rules without FSDP: the ``param_rules`` that make
    each group all-gather its FSDP-sharded weights once."""
    return logical_rules(plan, ParallelPlan(fsdp=False))


def tree_specs(axes_tree, rules: Dict[str, Any]):
    """An axes tree (dicts, lists, NamedTuples of axes tuples) → the same
    tree of specs."""
    if M.is_axes_leaf(axes_tree):
        return spec_from_axes(axes_tree, rules)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(v, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(tree_specs(v, rules) for v in axes_tree))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_specs(v, rules) for v in axes_tree)
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def _placements(mesh, specs):
    if isinstance(specs, dict):
        return {k: _placements(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_placements(mesh, v) for v in specs]
    if hasattr(specs, "_fields"):
        return type(specs)(*(_placements(mesh, v) for v in specs))
    return placements_from_spec(mesh, specs)


def param_specs(cfg: ModelConfig, plan: MeshPlan, pp: ParallelPlan
                ) -> Dict[str, Spec]:
    return tree_specs(M.param_axes(cfg), logical_rules(plan, pp))


def param_shardings(mesh, cfg: ModelConfig, plan: MeshPlan,
                    pp: ParallelPlan) -> Dict[str, tuple]:
    """``state_dict`` name → placements (the AdamW moments take the
    same)."""
    return _placements(mesh, param_specs(cfg, plan, pp))


def cache_specs(cfg: ModelConfig, plan: MeshPlan, pp: ParallelPlan,
                shape: ShapeConfig) -> list:
    rules = dict(logical_rules(plan, pp))
    rules["embed"] = None  # caches never FSDP-shard
    # a decode batch smaller than the data width: shard the KV-cache
    # sequence dim instead (sequence parallelism for decode)
    if shape.kind == "decode" and shape.global_batch < data_parallel(plan):
        rules["batch"] = None
        if pp.seq_shard_decode:
            rules["seq"] = ("data",)
    return tree_specs(M.cache_axes(cfg), rules)


def cache_shardings(mesh, cfg: ModelConfig, plan: MeshPlan,
                    pp: ParallelPlan, shape: ShapeConfig) -> list:
    return _placements(mesh, cache_specs(cfg, plan, pp, shape))


def batch_specs(cfg: ModelConfig, plan: MeshPlan, shape: ShapeConfig
                ) -> Dict[str, Spec]:
    """train: leaves are (mb, B/mb, seq[, ...]), the device batch axis 1;
    prefill / decode: (B, seq[, ...]), the device batch axis 0
    (replicated when B < dp, as long_500k's batch of 1)."""
    dp = data_parallel(plan)
    b_ax = plan.batch_axes if shape.global_batch >= dp else None
    b_ax = b_ax[0] if b_ax is not None and len(b_ax) == 1 else b_ax
    if shape.kind == "train":
        tok, fe = (None, b_ax, None), (None, b_ax, None, None)
    else:
        tok, fe = (b_ax, None), (b_ax, None, None)
    out = {"tokens": tok}
    if shape.kind == "train":
        out["labels"] = tok
    if cfg.frontend != "none":
        out["frontend_embeds"] = fe
    return out


def batch_shardings(mesh, cfg: ModelConfig, plan: MeshPlan,
                    shape: ShapeConfig) -> Dict[str, tuple]:
    return _placements(mesh, batch_specs(cfg, plan, shape))


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def _axis_sizes(plan: MeshPlan, model_axis: int = MODEL_AXIS
                ) -> Dict[str, int]:
    sizes = {"data": 16, "tp_kv": plan.tp_kv, "tp_g": plan.tp_g,
             "tp_r": plan.tp_r}
    assert plan.tp_kv * plan.tp_g * plan.tp_r == model_axis
    if plan.multi_pod:
        sizes["pod"] = 2
    return sizes


def local_shape(shape, spec: Spec, sizes: Dict[str, int],
                coord: Dict[str, int] = None) -> Tuple[int, ...]:
    """The chunk of a tensor of global ``shape`` that the rank at
    ``coord`` (mesh dim → index; 0 on every dim by default) holds under
    DTensor's splitting: each mesh dim in turn cuts the dim into
    ``ceil(n / size)``-sized pieces."""
    coord = coord or {}
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n, k = out[d], sizes[a]
            step = -(-n // k)
            out[d] = max(0, min(step, n - coord.get(a, 0) * step))
    return tuple(out)


def uneven(cfg: ModelConfig, plan: MeshPlan, pp: ParallelPlan
           ) -> List[Dict[str, Any]]:
    """Every parameter with a sharded dim that its mesh dims do not
    divide at production size: GSPMD pads it, DTensor chunks it."""
    sizes = _axis_sizes(plan)
    shapes = M.abstract_params(cfg)
    out = []
    for name, spec in param_specs(cfg, plan, pp).items():
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(sizes[a] for a in axes)
            if shapes[name].shape[d] % n:
                out.append({"param": name, "dim": d,
                            "size": int(shapes[name].shape[d]),
                            "axes": list(axes), "ways": n})
    return out


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------
def _own(t: torch.Tensor) -> torch.Tensor:
    """A fresh copy of ``t`` from a factory op: under a simulated rank set
    (``LocalTensorMode``) that is one tensor a rank, where ``t`` itself
    would be one storage shared by every rank's shard (and an in-place
    update of one rank's would reach the others)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out.copy_(t)


def distribute_model(model: nn.Module, mesh,
                     placements: Dict[str, tuple]) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor of its value
    under ``placements`` (``state_dict`` name → placements); in place,
    ``requires_grad`` kept."""
    for name, p in list(model.named_parameters()):
        path, _, leaf = name.rpartition(".")
        sub = model.get_submodule(path)
        d = distribute_tensor(_own(p.detach()), mesh, placements[name])
        sub._parameters[leaf] = nn.Parameter(d, requires_grad=p.requires_grad)
    return model


def distribute_tree(tree, mesh, placements):
    """Tensors of ``tree`` (dicts, lists, NamedTuples) distributed by the
    matching ``placements`` tree."""
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(_own(tree), mesh, placements)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, placements[k])
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(v, mesh, p)
                            for v, p in zip(tree, placements)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, mesh, p)
                          for v, p in zip(tree, placements))
    return tree


def local_dtensor(meta: torch.Tensor, mesh, placements, make) -> DTensor:
    """A DTensor of ``meta``'s global shape and dtype whose local shard
    (this rank's chunk) is ``make(local_shape, dtype)``: the global
    tensor is never built (production shapes on one card, or fake
    tensors)."""
    coord = mesh.get_coordinate()
    shape = list(meta.shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, k = shape[pl.dim], mesh.size(i)
            step = -(-n // k)
            shape[pl.dim] = max(0, min(step, n - coord[i] * step))
    return DTensor.from_local(make(tuple(shape), meta.dtype), mesh,
                              placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def local_model(cfg: ModelConfig, mesh, placements: Dict[str, tuple],
                make) -> nn.Module:
    """A ``Model`` whose parameters are :func:`local_dtensor`s: built on
    the ``meta`` device, nothing global allocated."""
    model = M.Model(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        path, _, leaf = name.rpartition(".")
        sub = model.get_submodule(path)
        sub._parameters[leaf] = nn.Parameter(
            local_dtensor(p, mesh, placements[name], make),
            requires_grad=False)
    return model


def local_tree(meta_tree, mesh, placements, make):
    """:func:`local_dtensor` over a tree of ``meta`` tensors."""
    if isinstance(meta_tree, torch.Tensor):
        return local_dtensor(meta_tree, mesh, placements, make)
    if isinstance(meta_tree, dict):
        return {k: local_tree(v, mesh, placements[k], make)
                for k, v in meta_tree.items()}
    if hasattr(meta_tree, "_fields"):
        return type(meta_tree)(*(local_tree(v, mesh, p, make)
                                 for v, p in zip(meta_tree, placements)))
    return [local_tree(v, mesh, p, make)
            for v, p in zip(meta_tree, placements)]
