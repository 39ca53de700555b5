"""Mamba-2 (SSD, state-space duality) token mixer.

Prefill uses the chunked SSD algorithm: attention-like products *within*
chunks of ``ssm_chunk`` tokens plus a linear recurrence *across* chunks.
Decode is the recurrent update, O(d_state · d_inner) a token whatever the
context. As in the reference, the fused ``in_proj`` is split into per-
component projections (z, x, B, C, dt), and the depthwise causal
convolution runs over the concatenated (x, B, C) stream (its
``opt_conv_split`` variant computes the same values, so it is not kept
apart here).

Precision follows the reference: projections in the activations' type
(``dt`` in f32), ``w_out`` summed in f32 before its cast (in the
activations' type in ``ssd_full`` under ``opt_bf16_grads``, the
reference's ``pet``), ``a_log``, ``d_skip`` and ``dt_bias`` in f32, the
recurrent state in f32. The reference's 3- and 4-operand einsums are
written out as two-operand products, taken in f32 over operands rounded to
the activations' type where the reference rounds them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Replicate, Shard

from .config import ModelConfig
from .layers import (F32, RMSNorm, bf16_grad_boundary, dense_init_,
                     gated_rmsnorm, matmul_heads, matmul_rows, _weight)
from .sharding_hints import grad_in_f32, hint, run_local, weight_in_f32


class SSM(nn.Module):
    """``wz``/``wx`` (d, d_inner), ``wb``/``wc`` (d, d_state), ``wdt``
    (d, heads), ``conv_w`` (conv_width, d_inner + 2·d_state), ``conv_b``,
    ``a_log``/``d_skip``/``dt_bias`` (heads,) in f32, ``out_norm``,
    ``w_out`` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        c = di + 2 * ds
        self.wz = _weight((d, di), dtype, device)
        self.wx = _weight((d, di), dtype, device)
        self.wb = _weight((d, ds), dtype, device)
        self.wc = _weight((d, ds), dtype, device)
        self.wdt = _weight((d, nh), dtype, device)
        self.conv_w = _weight((cfg.conv_width, c), dtype, device)
        self.conv_b = _weight((c,), dtype, device)
        self.a_log = _weight((nh,), F32, device)
        self.d_skip = _weight((nh,), F32, device)
        self.dt_bias = _weight((nh,), F32, device)
        self.out_norm = RMSNorm(di, dtype, device)
        self.w_out = _weight((di, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        """The reference's ``init_ssm`` distributions: dense matrices,
        ``conv_w`` N(0, 0.02²), ``conv_b`` 0, ``a_log`` log(1..heads),
        ``d_skip`` 1, ``dt_bias`` 0."""
        for n in ("wz", "wx", "wb", "wc", "wdt", "w_out"):
            dense_init_(getattr(self, n), gen)
        draw = torch.randn(self.conv_w.shape, generator=gen, dtype=F32,
                           device=self.conv_w.device)
        self.conv_w.copy_(draw.mul_(0.02))
        self.conv_b.zero_()
        nh = self.a_log.shape[0]
        self.a_log.copy_(torch.log(torch.arange(1, nh + 1, dtype=F32)))
        self.d_skip.fill_(1.0)
        self.dt_bias.zero_()


def axes_ssm():
    return {"wz": ("embed", "inner"), "wx": ("embed", "inner"),
            "wb": ("embed", None), "wc": ("embed", None),
            "wdt": ("embed", None),
            "conv_w": (None, "conv_chan"), "conv_b": ("conv_chan",),
            "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
            "out_norm": {"scale": ("inner",)},
            "w_out": ("inner", "embed")}


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (b, conv_width - 1, d_inner + 2·d_state)
    state: torch.Tensor  # (b, heads, headdim, d_state) f32


def ssm_cache_axes() -> SSMCache:
    return SSMCache(conv=("batch", None, "conv_chan"),
                    state=("batch", "ssm_heads", None, None))


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_width - 1,
                          cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                           cfg.ssm_state), dtype=F32, device=device))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) → (..., l, l) lower-triangular segment sums,
    out[i, j] = Σ_{j<k≤i} x[k], and -inf above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def _conv_taps(window: torch.Tensor, conv_w, conv_b, n: int) -> torch.Tensor:
    """Σ_i window[:, i:i+n] · conv_w[i], summed in the reference's order,
    then the bias, SiLU in f32, and back to the window's type."""
    out = window[:, 0:n] * conv_w[0]
    for i in range(1, conv_w.shape[0]):
        out = out + window[:, i:i + n] * conv_w[i]
    return F.silu((out + conv_b).to(F32)).to(window.dtype)


def _conv_full(conv_w, conv_b, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv1d over the sequence; xbc: (b, l, c)."""
    cw = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, cw - 1, 0))
    return _conv_taps(pad, conv_w, conv_b, xbc.shape[1])


def _project(p: SSM, cfg: ModelConfig, u: torch.Tensor):
    """→ z, x, B, C in u's type and the raw dt in f32 (with DTensor
    weights, each on its rank's columns: ``layers.matmul_heads``; u's
    gradient summed in f32 unless ``opt_bf16_grads``)."""
    if not cfg.opt_bf16_grads:
        u = grad_in_f32(u)
    mm = matmul_heads if isinstance(p.wz, DTensor) else torch.matmul
    dt_raw = mm(u.to(F32), weight_in_f32(p.wdt))
    return mm(u, p.wz), mm(u, p.wx), mm(u, p.wb), mm(u, p.wc), dt_raw


def _finish(p: SSM, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
            reduce_f32: bool = True) -> torch.Tensor:
    y = gated_rmsnorm(p.out_norm.scale, y, z, cfg.norm_eps)
    return matmul_rows(y, p.w_out, reduce_f32)


def ssd_full(p: SSM, cfg: ModelConfig, u: torch.Tensor,
             return_cache: bool = False):
    """u: (b, l, d) → (b, l, d); ``l`` must be a multiple of
    ``min(ssm_chunk, l)``. With ``return_cache``, also returns the
    :class:`SSMCache` (the conv tail and the terminal state) that decode
    continues from. With DTensor weights the scan runs on each rank's
    heads (:func:`_scan_sharded`)."""
    b, l, _ = u.shape
    ds = cfg.ssm_state
    cs = min(cfg.ssm_chunk, l)
    if l % cs:
        raise ValueError(f"seq {l} not a multiple of chunk {cs}")
    if cfg.opt_bf16_grads:
        u = bf16_grad_boundary(u)
    z, x, bmat, cmat, dt_raw = _project(p, cfg, u)
    # the reference's pins: x / z split on the inner dim, the small B / C
    # / dt streams whole
    z = hint(z, "batch", None, "inner")
    x = hint(x, "batch", None, "inner")
    bmat, cmat, dt_raw = (hint(t, "batch", None, None)
                          for t in (bmat, cmat, dt_raw))
    xbc_raw = torch.cat([x, bmat, cmat], -1)
    if isinstance(x, DTensor):
        y, carry = _scan_sharded(p, cfg, x, bmat, cmat, dt_raw)
    else:
        xbc = _conv_full(p.conv_w, p.conv_b, xbc_raw)
        x, bmat, cmat = torch.split(xbc, [cfg.d_inner, ds, ds], dim=-1)
        y, carry = _scan(cfg, x, bmat, cmat, dt_raw, p.a_log, p.d_skip,
                         p.dt_bias)
    out = _finish(p, cfg, y, z, not cfg.opt_bf16_grads)
    if return_cache:
        cw = cfg.conv_width
        return out, SSMCache(conv=xbc_raw[:, l - (cw - 1):, :], state=carry)
    return out


def _scan(cfg: ModelConfig, x, bmat, cmat, dt_raw, a_log, d_skip, dt_bias):
    """The chunked SSD scan over the conv'ed streams: x (b, l, heads ·
    headdim), B / C (b, l, d_state), the raw dt (b, l, heads) → (y (b, l,
    heads · headdim), terminal state (b, heads, headdim, d_state) f32).
    Heads are independent: any subset of them scans alone."""
    b, l, di = x.shape
    hd, ds = cfg.ssm_headdim, cfg.ssm_state
    nh = di // hd
    cs = min(cfg.ssm_chunk, l)
    nc = l // cs
    dt_ = x.dtype
    dt = F.softplus(dt_raw + dt_bias)                         # (b,l,h) f32
    a = -torch.exp(a_log)                                     # (h,)
    x = x.reshape(b, l, nh, hd)
    xc = x.reshape(b, nc, cs, nh, hd)
    bc = bmat.reshape(b, nc, cs, ds).to(F32)
    cc = cmat.reshape(b, nc, cs, ds).to(F32)
    dtc = dt.reshape(b, nc, cs, nh)
    da = dtc * a                                              # (b,nc,cs,h)
    da_cum = torch.cumsum(da, dim=2)

    # 1) intra-chunk (diagonal blocks):
    #    y[i] = Σ_j (C_i · B_j) L[h, i, j] xdt[j]
    li = torch.exp(_segsum(da.permute(0, 1, 3, 2)))          # (b,nc,h,i,j)
    xdt = (xc * dtc[..., None]).to(dt_).to(F32)               # (b,nc,j,h,p)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    m = cb[:, :, None] * li.to(dt_).to(F32)                   # (b,nc,h,i,j)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", m, xdt).to(dt_)

    # 2) per-chunk terminal states (f32)
    decay_st = torch.exp(da_cum[:, :, -1:, :] - da_cum)      # (b,nc,cs,h)
    weighted = xdt * decay_st.to(dt_).to(F32)[..., None]      # (b,nc,i,h,p)
    states = torch.einsum("bcihp,bcin->bchpn", weighted, bc)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(da_cum[:, :, -1, :])              # (b,nc,h)
    carry = torch.zeros((b, nh, hd, ds), dtype=F32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                        # (b,nc,h,p,n)

    # 4) state → output contribution
    state_decay = torch.exp(da_cum)                           # (b,nc,cs,h)
    y_off = torch.einsum("bcin,bchpn->bcihp", cc,
                         prev_states.to(dt_).to(F32))
    y_off = (y_off * state_decay.to(dt_).to(F32)[..., None]).to(dt_)

    y = (y_diag + y_off).reshape(b, l, nh, hd)
    y = y + (d_skip[:, None] * x).to(dt_)
    return y.reshape(b, l, di), carry


def _scan_sharded(p: SSM, cfg: ModelConfig, x, bmat, cmat, dt_raw):
    """:func:`_scan` after the conv, on each rank's heads: the depthwise
    conv runs per stream (x on its inner shard, B and C whole; per
    channel it is the same arithmetic as over the concatenation), the
    heads split by the ``inner`` rule when they divide, else whole."""
    mesh = x.device_mesh
    di, ds = cfg.d_inner, cfg.ssm_state
    inner = tuple(x.placements)
    ways = math.prod(mesh.size(i) for i, pl in enumerate(inner)
                     if pl == Shard(2))
    if cfg.ssm_heads % ways:
        inner = tuple(Replicate() if pl == Shard(2) else pl for pl in inner)
    batch = tuple(Replicate() if pl == Shard(2) else pl for pl in inner)
    rep = tuple(Replicate() for _ in inner)

    def on(pl, d):
        return tuple(Shard(d) if q == Shard(2) else
                     (Replicate() if isinstance(q, Shard) else q)
                     for q in pl)

    cw, cb = p.conv_w, p.conv_b
    args = (x, bmat, cmat, dt_raw,
            cw[:, :di], cb[:di], cw[:, di:di + ds], cb[di:di + ds],
            cw[:, di + ds:], cb[di + ds:], p.a_log, p.d_skip, p.dt_bias)
    heads = on(inner, 0)
    pls = (inner, batch, batch, inner, on(inner, 1), heads,
           rep, rep, rep, rep, heads, heads, heads)
    state = tuple(Shard(1) if q == Shard(2) else q for q in inner)

    def local(x, bmat, cmat, dt_raw, wx, bx, wb, bb, wc, bc, a_log, d_skip,
              dt_bias):
        return _scan(cfg, _conv_full(wx, bx, x), _conv_full(wb, bb, bmat),
                     _conv_full(wc, bc, cmat), dt_raw, a_log, d_skip,
                     dt_bias)

    return run_local(local, mesh, (inner, state), pls, *args)


def ssd_decode(p: SSM, cfg: ModelConfig, u: torch.Tensor, cache: SSMCache
               ) -> Tuple[torch.Tensor, SSMCache]:
    """u: (b, 1, d), one token a row; the recurrent update. The new conv
    tail and state are written into ``cache`` in place; returns
    ``(out, cache)``. Position-free, so packed decode is this too."""
    b = u.shape[0]
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    dt_ = u.dtype
    z, x, bmat, cmat, dt_raw = _project(p, cfg, u)
    xbc = torch.cat([x, bmat, cmat], -1)                      # (b,1,c)
    conv = torch.cat([cache.conv, xbc], 1)                    # (b,cw,c)
    out = _conv_taps(conv, p.conv_w, p.conv_b, 1)[:, 0]                        # (b,c)
    x, bmat, cmat = torch.split(out, [cfg.d_inner, ds, ds], dim=-1)

    dt = F.softplus(dt_raw[:, 0] + p.dt_bias)                 # (b,h)
    a = -torch.exp(p.a_log)
    da = torch.exp(dt * a)                                    # (b,h)
    xh = x.reshape(b, nh, hd).to(F32)
    dbx = (dt[..., None, None] * xh[..., :, None]
           * bmat.to(F32)[:, None, None, :])                 # (b,h,p,n)
    state = cache.state * da[..., None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", state, cmat.to(F32))
    y = y + p.d_skip[:, None] * xh
    y = y.reshape(b, 1, cfg.d_inner).to(dt_)
    out = _finish(p, cfg, y, z)
    cache.conv.copy_(conv[:, 1:])
    cache.state.copy_(state)
    return out, cache
