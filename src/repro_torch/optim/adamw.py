"""AdamW with dtype-configurable moments (``m_dtype`` / ``v_dtype``:
bf16 first moment + f32 second moment is 9 bytes a parameter instead of
12).

Parameters, gradients and moments are dicts of tensors keyed by the
model's parameter names. ``state = adamw_init(cfg, params)``;
``params, state, gnorm = adamw_update(cfg, grads, state, params, lr)``
writes the new parameters and moments **in place** (a 3B model has no
room for a second copy) and returns them with the count advanced. The
math is the reference's, in f32: global-norm clipping over every
gradient, bias-corrected moments, decoupled weight decay.

Weight decay goes where the reference applies it: to every leaf of at
least two dimensions *in the reference's layout*, which stacks each
layer's tensors over the groups. Every per-layer tensor (``layers.*``,
norm scales included) is therefore decayed, and of the rest only the
matrices (the embedding, an untied head), not ``final_norm``'s scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple

import torch

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "float32"   # "bfloat16" to halve first-moment memory
    v_dtype: str = "float32"


class AdamWState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: torch.Tensor        # 0-d int32, on the parameters' device


def adamw_init(cfg: AdamWConfig, params: Mapping[str, torch.Tensor]
               ) -> AdamWState:
    # zeros_like: a DTensor parameter's moments take its placements
    m = {k: torch.zeros_like(p, dtype=_DTYPES[cfg.m_dtype])
         for k, p in params.items()}
    v = {k: torch.zeros_like(p, dtype=_DTYPES[cfg.v_dtype])
         for k, p in params.items()}
    dev = next(iter(params.values())).device if params else "cpu"
    return AdamWState(m=m, v=v,
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    sq = torch.zeros((), dtype=F32,
                     device=next(iter(tree.values())).device)
    for x in tree.values():
        sq = sq + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(sq)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether ``name`` gets weight decay: its leaf in the reference's
    layout (per-layer tensors stacked over the groups) has ≥ 2 dims."""
    return p.ndim >= 2 or name.startswith("layers.")


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, params: Mapping[str, torch.Tensor], lr):
    """One AdamW step → ``(params, state, gnorm)``; ``gnorm`` is the
    pre-clip global norm. ``params`` and the moments are updated in
    place; ``lr`` is a float or a 0-d tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    c1 = 1.0 - cfg.b1 ** count.to(F32)
    c2 = 1.0 - cfg.b2 ** count.to(F32)
    for k, p in params.items():
        m, v = state.m[k], state.v[k]
        g = grads[k].to(F32) * scale
        m32 = m.to(F32) * cfg.b1 + g * (1.0 - cfg.b1)
        v32 = v.to(F32) * cfg.b2 + torch.square(g) * (1.0 - cfg.b2)
        del g
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        p32 = p.to(F32)
        if decays(k, p):
            step = step + cfg.weight_decay * p32
        p.copy_(p32 - lr * step)
    return params, AdamWState(m=state.m, v=state.v, count=count), gnorm
