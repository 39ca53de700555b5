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
reference feeds to its counting table. Under ``opt_bf16_grads`` the slot
buffer and the experts' output hand their gradients on in bf16
(``layers.bf16_grad_boundary``), where the reference puts its boundary:
across the token↔expert all-to-alls.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .config import ModelConfig
from .layers import F32, bf16_grad_boundary, dense_init_, _weight
from .sharding_hints import hint, run_local


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


def axes_moe(cfg: ModelConfig):
    p = {"router": ("embed", None)}
    if cfg.ffn_act == "swiglu":
        p["w_gate"] = ("experts", "embed", "ffn")
        p["w_up"] = ("experts", "embed", "ffn")
    else:
        p["w_in"] = ("experts", "embed", "ffn")
    p["w_down"] = ("experts", "ffn", "embed")
    return p


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
    """buf (b, e, c, d) → (b, e, c, d): every expert's FFN on its slots;
    with DTensor weights, each rank on its own experts (EP)."""
    names = ("w_gate", "w_up", "w_down") if cfg.ffn_act == "swiglu" \
        else ("w_in", "w_down")
    ws = [getattr(p, n) for n in names]
    if not isinstance(ws[-1], DTensor):
        return _expert_ffn(cfg, buf, *ws)
    ep = [Shard(0) if pl == Shard(0) else Replicate()
          for pl in ws[-1].placements]
    bp = [Shard(1) if q == Shard(0) else
          (pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate())
          for q, pl in zip(ep, buf.placements)]
    return run_local(lambda b_, *w_: _expert_ffn(cfg, b_, *w_),
                     ws[-1].device_mesh, bp, [bp] + [ep] * len(ws), buf,
                     *ws)


def _expert_ffn(cfg: ModelConfig, buf: torch.Tensor, *ws) -> torch.Tensor:
    dt = buf.dtype

    def mm(x, w):                                   # becd,edf->becf
        return torch.einsum("becd,edf->becf", x, w)

    if cfg.ffn_act == "swiglu":
        w_gate, w_up, w_down = ws
        h = (F.silu(mm(buf, w_gate).to(F32))
             * mm(buf, w_up).to(F32)).to(dt)
    else:
        w_in, w_down = ws
        h = mm(buf, w_in).to(F32)
        if cfg.ffn_act == "squared_relu":
            h = torch.square(F.relu(h)).to(dt)
        elif cfg.ffn_act == "gelu":
            h = F.gelu(h, approximate="tanh").to(dt)
        else:
            raise ValueError(cfg.ffn_act)
    return mm(h, w_down).to(dt)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (b, s, d) → (y (b, s, d), aux loss (f32 scalar), expert counts
    (e,) int32). With DTensor weights: :func:`_moe_sharded`."""
    if isinstance(p.router, DTensor):
        return _moe_sharded(p, cfg, x)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs_all, top_p, top_i, counts = _route(cfg, x, p.router)
    # ---- aux load-balance loss (Switch) + counting-table stats ----
    count_frac = counts.to(F32)
    aux = e * torch.mean(probs_all.mean((0, 1)) * (count_frac / (b * s * k)))
    buf, slot_of_assign, fp = _dispatch(cfg, x, top_p, top_i)
    out_buf = _boundary(cfg, _experts(p, cfg, _boundary(cfg, buf)))
    y = _combine(cfg, out_buf, slot_of_assign, fp)
    return y, aux, counts.to(torch.int32)


def _boundary(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    return bf16_grad_boundary(t) if cfg.opt_bf16_grads else t


def _route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """→ (router probabilities (b, s, e) f32, the top-k's renormalised
    probabilities and ids (b, s, k), assignments per expert (e,))."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.matmul(x.to(F32), router.to(F32))         # (b, s, e)
    probs_all = torch.softmax(logits, dim=-1)
    top_p, top_i = _topk(probs_all, k)                       # (b, s, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # (top_i == expert) summed, not bincount (no DTensor strategy)
    erange = torch.arange(e, device=x.device)
    counts = (top_i[..., None] == erange).sum(dim=(0, 1, 2))
    return probs_all, top_p, top_i, counts


def _dispatch(cfg: ModelConfig, x, top_p, top_i):
    """Grouped dispatch (group = batch row; capacity per group) → (the
    slot buffer (b, e, cap, d), each assignment's slot (b, s·k), e·cap
    where dropped, and its weight (b, s·k))."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dev = x.device
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
    # start[b, e'] = first sorted index of expert e' in row b: the count
    # of the row's sorted ids below e' (searchsorted's left side, without
    # it: no DTensor strategy)
    erange = torch.arange(e + 1, device=dev)
    start = (se[:, :, None] < erange).sum(dim=1)
    cidx = torch.arange(cap, device=dev)
    j = start[:, :e, None] + cidx[None, None, :]             # (b, e, cap)
    slot_valid = j < start[:, 1:, None]
    j_flat = torch.clamp(j, 0, sk - 1).reshape(b, e * cap)
    tok_for_slot = torch.take_along_dim(stok, j_flat, -1)    # (b, e*cap)
    buf = torch.gather(x, 1, tok_for_slot[..., None].expand(b, e * cap, d))
    buf = torch.where(slot_valid.reshape(b, e * cap)[..., None], buf,
                      torch.zeros((), dtype=x.dtype, device=dev))
    # assignment t*k+i sits at sorted place inv[t*k+i]
    inv = torch.argsort(order, dim=-1, stable=True)
    slot_of_sorted = torch.where(keep, se * cap + pos, e * cap)
    slot_of_assign = torch.take_along_dim(slot_of_sorted, inv, -1)
    return buf.reshape(b, e, cap, d), slot_of_assign, fp


def _combine(cfg: ModelConfig, out_buf, slot_of_assign, fp):
    """Gather-only combine: each token's k contributions read back from
    the flat slot buffer, weighted → y (b, s, d)."""
    b, e, cap, d = out_buf.shape
    k = cfg.experts_per_token
    sk = slot_of_assign.shape[1]
    flat = out_buf.reshape(b, e * cap, d)
    safe = torch.clamp(slot_of_assign, 0, e * cap - 1)
    contrib = torch.gather(flat, 1, safe[..., None].expand(b, sk, d))
    w = (fp * (slot_of_assign < e * cap)).to(contrib.dtype)
    return (contrib * w[..., None]).reshape(b, sk // k, k, d).sum(dim=2)


def _moe_sharded(p: MoE, cfg: ModelConfig, x):
    """:func:`moe_apply` over DTensors, where the reference places its
    hints: routing, dispatch and combine stay row-local (each rank on its
    batch rows, the model dims whole), the slot buffer moves to the
    experts' ranks (``(batch, experts, …)``: the token→expert all-to-all)
    and back (``(batch, …)``). Routing and dispatch run on local shards
    (sorts, cumulative maxima and gathers along a row have no DTensor
    strategy to trust); the aux loss comes from sums over the rows."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    mesh = p.router.device_mesh
    x = hint(x, "batch", None, None)
    rows = tuple(pl if pl == Shard(0) else Replicate() for pl in x.placements)
    rep = tuple(Replicate() for _ in rows)
    summed = tuple(Partial() if pl == Shard(0) else pl for pl in rows)

    def route(x_, router):
        probs_all, top_p, top_i, counts = _route(cfg, x_, router)
        buf, slot, fp = _dispatch(cfg, x_, top_p, top_i)
        return buf, slot, fp, probs_all.sum((0, 1)), counts

    buf, slot, fp, psum, counts = run_local(
        route, mesh, (rows, rows, rows, summed, summed), (rows, rep),
        x, p.router)
    buf = hint(_boundary(cfg, buf), "batch", "experts", None, None)
    out_buf = hint(_boundary(cfg, _experts(p, cfg, buf)), "batch",
                   "experts", None, None)
    out_buf = hint(out_buf, "batch", None, None, None)
    y = run_local(lambda o, sl, w: _combine(cfg, o, sl, w), mesh, rows,
                  (rows, rows, rows), out_buf, slot, fp)
    counts = counts.redistribute(mesh, rep)
    psum = psum.redistribute(mesh, rep)
    aux = e * torch.mean((psum / (b * s)) * (counts.to(F32) / (b * s * k)))
    return hint(y, "batch", None, None), aux, counts.to(torch.int32)
