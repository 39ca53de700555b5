"""Shared layer primitives: norms, RoPE, embeddings, dense FFN variants.

Weights live in ``nn.Module``s whose parameter names and shapes are the
reference's pytree leaves (``scale``, ``tokens``, ``w_gate``, ...), so a
reference pytree maps onto a ``state_dict`` by name (``convert.py``).
Each ``forward`` computes what the reference's function of the same name
does, in the same precision steps: norms, RoPE and the softmax in f32,
matrix products in the activations' type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

F32 = torch.float32
NEG = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a config's ``dtype`` string."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(name)
    if dt is None:
        raise ValueError(f"unsupported dtype {name!r}")
    return dt


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(w: torch.Tensor, gen: torch.Generator,
                in_axis: int = 0) -> None:
    """Fill ``w`` in place with N(0, 1) / sqrt(fan_in) drawn in f32 on its
    device (the reference's ``_dense_init`` distribution)."""
    fan_in = max(w.shape[in_axis], 1)
    draw = torch.randn(w.shape, generator=gen, dtype=F32, device=w.device)
    w.copy_(draw.mul_(1.0 / fan_in ** 0.5))    # one f32 temporary, not two


def matmul_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->...", x, w)``: contract x's last axis with w's
    first, keeping w's other axes."""
    d = w.shape[0]
    return torch.matmul(x, w.reshape(d, -1)).reshape(*x.shape[:-1],
                                                     *w.shape[1:])


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(dt)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba-2's output norm: RMSNorm(x · silu(gate)), the gate taken in
    f32 and cast to x's type before the product."""
    return rmsnorm(scale, x * F.silu(gate.to(F32)).to(x.dtype), eps)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _weight((d,), dtype, device)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions: (...,) int → (..., dim//2) f32 angles."""
    exps = torch.arange(0, dim, 2, dtype=F32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    return positions[..., None].to(F32) * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    d = x.shape[-1]
    ang = rope_angles(positions, d, theta)          # (..., seq, d/2)
    cos = torch.cos(ang)[..., None, :]              # (..., seq, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------
class Embed(nn.Module):
    """``tokens`` (padded_vocab, d); ``head`` (d, padded_vocab) unless the
    embeddings are tied."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        v = cfg.padded_vocab
        self.tokens = _weight((v, cfg.d_model), dtype, device)
        if not cfg.tie_embeddings:
            self.head = _weight((cfg.d_model, v), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        draw = torch.randn(self.tokens.shape, generator=gen, dtype=F32,
                           device=self.tokens.device)
        self.tokens.copy_(draw.mul_(0.02))
        del draw
        if hasattr(self, "head"):
            dense_init_(self.head, gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.tokens[ids]


def lm_logits(embed: Embed, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) → (..., padded_vocab) f32 logits; padding lanes masked.

    The product runs in x's type and is then widened: in bf16 the logits
    carry bf16 rounding (the reference accumulates them into f32)."""
    w = embed.tokens.t() if cfg.tie_embeddings else embed.head
    logits = torch.matmul(x, w).to(F32)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG
    return logits


# ---------------------------------------------------------------------------
# Dense FFN (swiglu / gelu / squared_relu)
# ---------------------------------------------------------------------------
class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.ffn_act == "swiglu":
            self.w_gate = _weight((d, f), dtype, device)
            self.w_up = _weight((d, f), dtype, device)
        else:
            self.w_in = _weight((d, f), dtype, device)
        self.w_down = _weight((f, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        names = (("w_gate", "w_up") if hasattr(self, "w_gate")
                 else ("w_in",)) + ("w_down",)
        for n in names:
            dense_init_(getattr(self, n), gen)


def ffn_apply(p: FFN, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.ffn_act == "swiglu":
        g = torch.matmul(x, p.w_gate).to(F32)
        u = torch.matmul(x, p.w_up).to(F32)
        h = (F.silu(g) * u).to(dt)
    else:
        h = torch.matmul(x, p.w_in).to(F32)
        if cfg.ffn_act == "gelu":
            h = F.gelu(h, approximate="tanh").to(dt)
        elif cfg.ffn_act == "squared_relu":   # Nemotron-4 (Primer)
            h = torch.square(F.relu(h)).to(dt)
        else:
            raise ValueError(cfg.ffn_act)
    return torch.matmul(h, p.w_down).to(dt)
