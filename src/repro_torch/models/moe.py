"""Mixture-of-Experts channel mixer: top-k routing with sort-based dispatch.

Token→expert assignments are argsorted by expert within each batch row
(the row is the dispatch group), packed into per-expert capacity buffers
of ``max(int(capacity_factor · s · k / e), 1)`` slots (assignments past
an expert's capacity are dropped), run through the experts as one batched
product over the experts axis, and combined back by gathers weighted with
the renormalised router probabilities. The steps are the reference's:
stable argsorts, a running maximum for each assignment's place in its
expert's run, a per-row ``searchsorted`` for the run starts, gather-only
combine. The router stays f32 in a bf16 model.

``moe_apply`` also returns the Switch load-balancing loss and the
per-expert assignment counts (before the capacity drop), which the
reference feeds to its counting table.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import F32, dense_init_, _weight


class MoE(nn.Module):
    """``router`` (d, e) in f32; ``w_gate`` / ``w_up`` (e, d, f) for
    swiglu experts, else ``w_in`` (e, d, f); ``w_down`` (e, f, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = _weight((d, e), F32, device)
        if cfg.ffn_act == "swiglu":
            self.w_gate = _weight((e, d, f), dtype, device)
            self.w_up = _weight((e, d, f), dtype, device)
        else:
            self.w_in = _weight((e, d, f), dtype, device)
        self.w_down = _weight((e, f, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        dense_init_(self.router, gen)
        names = (("w_gate", "w_up") if hasattr(self, "w_gate")
                 else ("w_in",)) + ("w_down",)
        for n in names:
            dense_init_(getattr(self, n), gen, in_axis=1)


def _topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative-argmax top-k over the last axis → (values, int64 ids),
    each (..., k). Ties go to the lowest id (``torch.argmax``'s first
    maximum, as ``jnp.argmax``); a chosen lane is pushed down by 2 before
    the next round, as the reference does."""
    p = probs
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        vals.append(torch.amax(p, dim=-1))
        idxs.append(i)
        p = p - F.one_hot(i, p.shape[-1]).to(p.dtype) * 2.0
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _experts(p: MoE, cfg: ModelConfig, buf: torch.Tensor) -> torch.Tensor:
    """buf (b, e, c, d) → (b, e, c, d): every expert's FFN on its slots."""
    dt = buf.dtype

    def mm(x, w):                                   # becd,edf->becf
        return torch.einsum("becd,edf->becf", x, w)

    if cfg.ffn_act == "swiglu":
        h = (F.silu(mm(buf, p.w_gate).to(F32))
             * mm(buf, p.w_up).to(F32)).to(dt)
    else:
        h = mm(buf, p.w_in).to(F32)
        if cfg.ffn_act == "squared_relu":
            h = torch.square(F.relu(h)).to(dt)
        elif cfg.ffn_act == "gelu":
            h = F.gelu(h, approximate="tanh").to(dt)
        else:
            raise ValueError(cfg.ffn_act)
    return mm(h, p.w_down).to(dt)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (b, s, d) → (y (b, s, d), aux loss (f32 scalar), expert counts
    (e,) int32)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dev = x.device
    logits = torch.matmul(x.to(F32), p.router.to(F32))       # (b, s, e)
    probs_all = torch.softmax(logits, dim=-1)
    top_p, top_i = _topk(probs_all, k)                       # (b, s, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- aux load-balance loss (Switch) + counting-table stats ----
    counts = torch.bincount(top_i.reshape(-1), minlength=e)
    count_frac = counts.to(F32)
    aux = e * torch.mean(probs_all.mean((0, 1)) * (count_frac / (b * s * k)))

    # ---- grouped dispatch (group = batch row; capacity per group) ----
    cap = max(int(cfg.capacity_factor * s * k / e), 1)
    sk = s * k
    fe = top_i.reshape(b, sk)
    fp = top_p.reshape(b, sk)
    ftok = torch.arange(s, device=dev).repeat_interleave(k).expand(b, sk)
    order = torch.argsort(fe, dim=-1, stable=True)
    se = torch.take_along_dim(fe, order, -1)
    stok = torch.take_along_dim(ftok, order, -1)
    # each assignment's place within its expert's run, per row
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                       se[:, 1:] != se[:, :-1]], -1)
    runpos = torch.arange(sk, device=dev).expand(b, sk)
    run_start = torch.cummax(torch.where(first, runpos, 0), dim=1).values
    pos = runpos - run_start
    keep = pos < cap                                         # capacity drop
    # start[b, e'] = first sorted index of expert e' in row b
    erange = torch.arange(e + 1, device=dev).expand(b, e + 1).contiguous()
    start = torch.searchsorted(se.contiguous(), erange, side="left")
    cidx = torch.arange(cap, device=dev)
    j = start[:, :e, None] + cidx[None, None, :]             # (b, e, cap)
    slot_valid = j < start[:, 1:, None]
    j_flat = torch.clamp(j, 0, sk - 1).reshape(b, e * cap)
    tok_for_slot = torch.take_along_dim(stok, j_flat, -1)    # (b, e*cap)
    buf = torch.gather(x, 1, tok_for_slot[..., None].expand(b, e * cap, d))
    buf = torch.where(slot_valid.reshape(b, e * cap)[..., None], buf,
                      torch.zeros((), dtype=x.dtype, device=dev))
    out_buf = _experts(p, cfg, buf.reshape(b, e, cap, d))
    # ---- combine (gather-only): assignment t*k+i sits at sorted place
    # inv[t*k+i]; read it back from the flat slot buffer ----
    inv = torch.argsort(order, dim=-1, stable=True)
    slot_of_sorted = torch.where(keep, se * cap + pos, e * cap)
    slot_of_assign = torch.take_along_dim(slot_of_sorted, inv, -1)
    flat = out_buf.reshape(b, e * cap, d)
    safe = torch.clamp(slot_of_assign, 0, e * cap - 1)
    contrib = torch.gather(flat, 1, safe[..., None].expand(b, sk, d))
    w = (fp * (slot_of_assign < e * cap)).to(contrib.dtype)
    y = (contrib * w[..., None]).reshape(b, s, k, d).sum(dim=2)
    return y, aux, counts.to(torch.int32)
