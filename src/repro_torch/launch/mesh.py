"""Device meshes for the production pods, as ``torch.distributed``
``DeviceMesh``es.

``make_production_mesh`` is the entry point: a 16×16 = 256-device pod
(dims ``data × model``), or 2×16×16 = 512 devices with a leading ``pod``
dim (data parallelism across pods). It spans ranks ``0..n-1`` of the
default process group, which must hold at least that many ranks: the
dry-run runs it over a fake group of 512 on one host, a real job over
one rank a device.

Per-architecture factoring: attention shards over the ``model`` dim split
into (kv, group, replica) sub-dims, so GQA head counts that do not divide
16 still shard cleanly. ``arch_mesh`` reshapes the same rank array into
``(pod?, data, tp_kv, tp_g, tp_r)``: the same devices, the split nested
inside the ``model`` dim (kv outermost), only finer dim names. The
factoring itself (:func:`plan_for`) is the reference's arithmetic.

Meshes are on ``"cuda"`` unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.config import ModelConfig

MODEL_AXIS = 16  # model-parallel width of one pod row


def _mesh(device_type: str, shape: Tuple[int, ...],
          names: Tuple[str, ...]) -> DeviceMesh:
    n = math.prod(shape)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """``(data=16, model=16)``, or ``(pod=2, data=16, model=16)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, names)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Per-arch factoring of the model dim (tp_kv · tp_g · tp_r = its
    width)."""

    tp_kv: int      # shards kv_heads (GQA) / the q-head block (MLA)
    tp_g: int       # shards the q-head group dim (heads // kv_heads)
    tp_r: int       # attention-replicated remainder (FFN / EP still use it)
    multi_pod: bool

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def tp_axes(self) -> Tuple[str, ...]:
        return ("tp_kv", "tp_g", "tp_r")

    @property
    def heads_axes(self) -> Tuple[str, ...]:
        return ("tp_kv", "tp_g")

    @property
    def attn_tp(self) -> int:
        return self.tp_kv * self.tp_g


def plan_for(cfg: ModelConfig, *, multi_pod: bool = False,
             model_axis: int = MODEL_AXIS) -> MeshPlan:
    m = model_axis
    if cfg.layer_pattern == ("ssm",) * len(cfg.layer_pattern):
        return MeshPlan(1, 1, m, multi_pod)          # attention-free
    if cfg.attn_type == "mla":
        # the latent is shared by the heads: factor the q heads directly
        mh = math.gcd(cfg.num_heads, m)
        return MeshPlan(mh, 1, m // mh, multi_pod)
    kv = math.gcd(cfg.num_kv_heads, m)
    g = cfg.num_heads // cfg.num_kv_heads
    mg = math.gcd(g, m // kv)
    return MeshPlan(kv, mg, m // (kv * mg), multi_pod)


def arch_mesh(base: DeviceMesh, plan: MeshPlan) -> DeviceMesh:
    """``base``'s rank array reshaped to the arch's factoring of its last
    (model) dim, kv outermost. Sub-dims of size 1 are left out of the
    mesh (a spec naming one shards nothing, ``placements_from_spec``):
    DTensor plans each op over every mesh dim, and a size-1 dim costs
    that planning time for no split."""
    ranks = base.mesh
    shape = tuple(ranks.shape[:-1]) + (plan.tp_kv, plan.tp_g, plan.tp_r)
    names = (("pod",) if plan.multi_pod else ()) + ("data",) + plan.tp_axes
    keep = [i for i, n in enumerate(shape) if n > 1 or i < ranks.ndim - 1]
    return DeviceMesh(base.device_type, ranks.reshape(shape).reshape(
        [shape[i] for i in keep]),
        mesh_dim_names=tuple(names[i] for i in keep))


def small_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over ranks ``0..prod(shape)-1`` (tests, one
    card, sub-meshes)."""
    return _mesh(device_type, tuple(shape), tuple(axes))
