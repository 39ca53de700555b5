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
(``dt`` in f32), ``a_log``, ``d_skip`` and ``dt_bias`` in f32, the
recurrent state in f32. The reference's 3- and 4-operand einsums are
written out as two-operand products, taken in f32 over operands rounded to
the activations' type where the reference rounds them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import F32, RMSNorm, dense_init_, gated_rmsnorm, _weight


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


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (b, conv_width - 1, d_inner + 2·d_state)
    state: torch.Tensor  # (b, heads, headdim, d_state) f32


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


def _conv_taps(window: torch.Tensor, p: SSM, n: int) -> torch.Tensor:
    """Σ_i window[:, i:i+n] · conv_w[i], summed in the reference's order,
    then the bias, SiLU in f32, and back to the window's type."""
    out = window[:, 0:n] * p.conv_w[0]
    for i in range(1, p.conv_w.shape[0]):
        out = out + window[:, i:i + n] * p.conv_w[i]
    return F.silu((out + p.conv_b).to(F32)).to(window.dtype)


def _conv_full(p: SSM, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv1d over the sequence; xbc: (b, l, c)."""
    cw = p.conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, cw - 1, 0))
    return _conv_taps(pad, p, xbc.shape[1])


def _project(p: SSM, u: torch.Tensor):
    """→ z, x, B, C in u's type and the raw dt in f32."""
    mm = torch.matmul
    dt_raw = mm(u.to(F32), p.wdt.to(F32))
    return mm(u, p.wz), mm(u, p.wx), mm(u, p.wb), mm(u, p.wc), dt_raw


def _finish(p: SSM, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor
            ) -> torch.Tensor:
    y = gated_rmsnorm(p.out_norm.scale, y, z, cfg.norm_eps)
    return torch.matmul(y, p.w_out)


def ssd_full(p: SSM, cfg: ModelConfig, u: torch.Tensor,
             return_cache: bool = False):
    """u: (b, l, d) → (b, l, d); ``l`` must be a multiple of
    ``min(ssm_chunk, l)``. With ``return_cache``, also returns the
    :class:`SSMCache` (the conv tail and the terminal state) that decode
    continues from."""
    b, l, _ = u.shape
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    cs = min(cfg.ssm_chunk, l)
    if l % cs:
        raise ValueError(f"seq {l} not a multiple of chunk {cs}")
    nc = l // cs
    dt_ = u.dtype
    z, x, bmat, cmat, dt_raw = _project(p, u)
    xbc_raw = torch.cat([x, bmat, cmat], -1)
    xbc = _conv_full(p, xbc_raw)
    x, bmat, cmat = torch.split(xbc, [cfg.d_inner, ds, ds], dim=-1)

    dt = F.softplus(dt_raw + p.dt_bias)                       # (b,l,h) f32
    a = -torch.exp(p.a_log)                                   # (h,)
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
    carry = torch.zeros((b, nh, hd, ds), dtype=F32, device=u.device)
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
    y = y + (p.d_skip[:, None] * x).to(dt_)
    out = _finish(p, cfg, y.reshape(b, l, cfg.d_inner), z)
    if return_cache:
        cw = cfg.conv_width
        return out, SSMCache(conv=xbc_raw[:, l - (cw - 1):, :], state=carry)
    return out


def ssd_decode(p: SSM, cfg: ModelConfig, u: torch.Tensor, cache: SSMCache
               ) -> Tuple[torch.Tensor, SSMCache]:
    """u: (b, 1, d), one token a row; the recurrent update. The new conv
    tail and state are written into ``cache`` in place; returns
    ``(out, cache)``. Position-free, so packed decode is this too."""
    b = u.shape[0]
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    dt_ = u.dtype
    z, x, bmat, cmat, dt_raw = _project(p, u)
    xbc = torch.cat([x, bmat, cmat], -1)                      # (b,1,c)
    conv = torch.cat([cache.conv, xbc], 1)                    # (b,cw,c)
    out = _conv_taps(conv, p, 1)[:, 0]                        # (b,c)
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
