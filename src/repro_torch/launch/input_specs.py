"""Shape-and-dtype stand-ins for every model input: ``meta`` tensors, no
allocation (the reference's ``ShapeDtypeStruct``s).

Train batches arrive pre-microbatched: ``(mb, B/mb, S)``, the device
batch on axis 1, placed over (pod,) data by ``sharding.batch_specs``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import model as M
from ..models.config import ModelConfig, ShapeConfig
from ..models.layers import torch_dtype
from .sharding import ParallelPlan

META = torch.device("meta")


def effective_microbatches(pp: ParallelPlan, shape: ShapeConfig,
                           dp: int) -> int:
    """The largest mb ≤ the plan's that keeps B/mb divisible by dp."""
    mb = pp.microbatches
    while mb > 1 and (shape.global_batch % mb != 0
                      or (shape.global_batch // mb) % dp != 0):
        mb //= 2
    return max(mb, 1)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_specs(cfg: ModelConfig, shape: ShapeConfig, mb: int
                ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch // mb, shape.seq_len
    specs = {"tokens": _meta((mb, b, s), torch.int32),
             "labels": _meta((mb, b, s), torch.int32)}
    if cfg.frontend != "none":
        specs["frontend_embeds"] = _meta((mb, b, cfg.num_patches,
                                          cfg.d_model), torch_dtype(cfg.dtype))
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig
                  ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int32)}
    if cfg.frontend != "none":
        specs["frontend_embeds"] = _meta((b, cfg.num_patches, cfg.d_model),
                                         torch_dtype(cfg.dtype))
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """One new token against a ``seq_len``-deep cache."""
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _meta((b, 1), torch.int32),
            "caches": M.abstract_caches(cfg, b, s, torch_dtype(cfg.dtype)),
            "index": _meta((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mb: int = 1
                ) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_specs(cfg, shape, mb)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)
