"""int8 error-feedback gradient compression for the cross-node gradient
sum.

Across nodes the gradient all-reduce crosses the data-center network;
int8 quantization with per-leaf scales cuts those bytes 2x against bf16
(4x against f32) at the cost of quantization noise, which the
error-feedback accumulator re-injects next step (1-bit-Adam lineage:
Seide et al. 2014; arXiv:2102.02888).

``compressed_psum(grads, group, states)`` runs over a
:class:`~repro_torch.core.distributed.ShardGroup`: ``grads[i]`` and
``states[i]`` belong to local shard ``i``, the scale is the maximum over
every shard (``pmax`` across processes), the int8 values are summed as
int32 over every shard (``psum``), and each shard gets the mean.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

F32 = torch.float32


class CompressionState(NamedTuple):
    error: Dict[str, torch.Tensor]   # f32 residuals, one per gradient


def compress_init(params: Dict[str, torch.Tensor]) -> CompressionState:
    return CompressionState(error={
        k: torch.zeros(p.shape, dtype=F32, device=p.device)
        for k, p in params.items()})


def _scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def _round(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(x)
    return _round(x, scale), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compressed_psum(grads: Sequence[Dict[str, torch.Tensor]], group,
                    states: Sequence[CompressionState]
                    ) -> Tuple[List[Dict[str, torch.Tensor]],
                               List[CompressionState]]:
    """The mean over every shard of ``group`` of each gradient, summed in
    int8 with error feedback → (the f32 means for each local shard, on
    its device; each shard's new state). The scale is shared, so every
    shard dequantizes identically."""
    if len(grads) != len(group.local_shards) or len(states) != len(grads):
        raise ValueError(f"{len(grads)} gradients and {len(states)} states "
                         f"for {len(group.local_shards)} local shards")
    means: List[Dict[str, torch.Tensor]] = [{} for _ in grads]
    errs: List[Dict[str, torch.Tensor]] = [{} for _ in grads]
    for k in grads[0]:
        g32 = [g[k].to(F32) + st.error[k] for g, st in zip(grads, states)]
        scale = torch.stack([_scale(x).to(group.home) for x in g32]).max()
        scale = group.pmax(scale)
        qs = []
        for i, x in enumerate(g32):
            s = scale.to(x.device)
            q = _round(x, s)
            errs[i][k] = x - q.to(F32) * s
            qs.append(q.to(torch.int32))
        total = group.psum(qs)
        mean = total.to(F32) * scale / float(group.num_shards)
        for i, x in enumerate(g32):
            means[i][k] = mean.to(x.device)
    return means, [CompressionState(error=e) for e in errs]
