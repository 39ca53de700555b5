"""Shared layer primitives: norms, RoPE, embeddings, dense FFN variants.

Weights live in ``nn.Module``s whose parameter names and shapes are the
reference's pytree leaves (``scale``, ``tokens``, ``w_gate``, ...), so a
reference pytree maps onto a ``state_dict`` by name (``convert.py``).
Each ``forward`` computes what the reference's function of the same name
does, in the same precision steps: norms, RoPE and the softmax in f32,
matrix products in the activations' type. Every module's ``axes_*``
sibling names the logical axis of each parameter dim (the reference's
``axes_*``), which ``launch/sharding.py`` maps onto a device mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from .config import ModelConfig
from .sharding_hints import column_parallel, row_parallel, run_local

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
    first, keeping w's other axes. With a DTensor ``w``, column-parallel
    on each rank's shard (``sharding_hints.column_parallel``)."""
    if not isinstance(w, DTensor):
        return _matmul_heads(x, w)
    return column_parallel(_matmul_heads, x, w)


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract x's trailing axes with all of w's but its last
    (``x @ w`` for a 2-D w, ``einsum("bshk,hkd->bsd")`` for a 3-D one).
    With a DTensor ``w``, row-parallel on each rank's shard of the
    contracted axes (``sharding_hints.row_parallel``)."""
    if not isinstance(w, DTensor):
        return _matmul_rows(x, w)
    return row_parallel(_matmul_rows, x, w)


def _matmul_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    d = w.shape[0]
    return torch.matmul(x, w.reshape(d, -1)).reshape(*x.shape[:-1],
                                                     *w.shape[1:])


def _matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if w.ndim == 2:               # no reshape: the unsharded ops stay as they were
        return torch.matmul(x, w)
    k = w.ndim - 1
    return torch.matmul(x.reshape(*x.shape[:x.ndim - k], -1),
                        w.reshape(-1, w.shape[-1]))


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


def axes_rmsnorm():
    return {"scale": ("embed",)}


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
        if isinstance(self.tokens, DTensor):
            return _vocab_parallel_lookup(self.tokens, ids)
        return self.tokens[ids]


def _vocab_parallel_lookup(table: DTensor, ids: torch.Tensor) -> DTensor:
    """``table[ids]`` with the rows split over mesh dims, each rank on its
    rows: a row it does not hold reads as 0, and the sum over those mesh
    dims (one nonzero term) is the row. DTensor's own indexing gathers
    the whole table first."""
    mesh = table.device_mesh
    rows = [Shard(0) if pl == Shard(0) else Replicate()
            for pl in table.placements]
    ip = tuple(pl if isinstance(pl, Shard) and not r == Shard(0)
               else Replicate() for pl, r in zip(ids.placements, rows))
    lanes = distribute_tensor(torch.arange(table.shape[0],
                                           device=table.device), mesh, rows)
    out = [Partial() if r == Shard(0) else pl for r, pl in zip(rows, ip)]

    def local(t, i, lane):
        n = t.shape[0]
        lo = lane[:1]
        at = i.long() - lo
        hit = (at >= 0) & (at < n)
        got = t[at.clamp(0, max(n - 1, 0))]
        return got * hit[..., None].to(got.dtype)

    return run_local(local, mesh, out, [rows, ip, rows], table, ids, lanes)


def axes_embed(cfg: ModelConfig):
    p = {"tokens": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["head"] = ("embed", "vocab")
    return p


def lm_logits(embed: Embed, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) → (..., padded_vocab) f32 logits; padding lanes masked.

    The product runs in x's type and is then widened: in bf16 the logits
    carry bf16 rounding (the reference accumulates them into f32)."""
    w = embed.tokens.t() if cfg.tie_embeddings else embed.head
    # a vocab-split head: column-parallel on each rank's lanes
    mm = matmul_heads if isinstance(w, DTensor) else torch.matmul
    logits = mm(x, w).to(F32)
    if cfg.padded_vocab != cfg.vocab_size:
        # out of place: a vocab-sharded DTensor has no in-place fill
        lane = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(lane < cfg.vocab_size, logits, NEG)
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


def axes_ffn(cfg: ModelConfig):
    if cfg.ffn_act == "swiglu":
        return {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
                "w_down": ("ffn", "embed")}
    return {"w_in": ("embed", "ffn"), "w_down": ("ffn", "embed")}


def ffn_apply(p: FFN, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """With DTensor weights, Megatron's column- then row-parallel pair
    (:func:`matmul_heads`, :func:`matmul_rows`) on each rank's ffn lanes:
    a partial sum over the mesh dims that split them (DTensor's own
    propagation may gather the whole weight)."""
    dt = x.dtype
    sharded = isinstance(p.w_down, DTensor)
    col = matmul_heads if sharded else torch.matmul
    row = matmul_rows if sharded else torch.matmul
    if cfg.ffn_act == "swiglu":
        g = col(x, p.w_gate).to(F32)
        u = col(x, p.w_up).to(F32)
        h = (F.silu(g) * u).to(dt)
    else:
        h = col(x, p.w_in).to(F32)
        if cfg.ffn_act == "gelu":
            h = F.gelu(h, approximate="tanh").to(dt)
        elif cfg.ffn_act == "squared_relu":   # Nemotron-4 (Primer)
            h = torch.square(F.relu(h)).to(dt)
        else:
            raise ValueError(cfg.ffn_act)
    return row(h, p.w_down).to(dt)
