"""Attention token mixers: GQA (+RoPE) and MLA (MiniCPM3 / DeepSeek
latent attention, with absorbed-projection decode).

* ``gqa_full`` / ``mla_full`` — prefill over the whole sequence (causal).
  Its attention is the flash-attention kernel (``kernels/flash_attn``)
  under either ``attn_impl``: the reference's dense ``_sdpa`` and chunked
  ``_sdpa_chunked`` compute the same function, which is the kernel's. MLA
  expands its latent into per-head K/V first (d = nope + rope, dv =
  v_head, kvh = h).
* ``*_decode`` — one new token against a cache, written into the cache
  **in place**; callers hand it caches they own (``model.pad_caches``
  always returns fresh storage).
* ``*_decode_packed`` — one token per row of a packed slot table, each
  row at its own position: a per-row write and a per-row (b, t) mask.
* ``*_chunk_append`` — a chunk of prefill at absolute positions
  ``start..start+c`` written into the cache in place and attended
  causally over the whole cache.

GQA caches (k, v); MLA caches the normed latent and the shared roped key
(``kv_lora + rope_dim`` a token, not ``2·kvh·hd``) and attends in latent
space (``_mla_absorbed_attend``). The three cache modes are plain torch,
as the reference computes them with jnp outside any Pallas kernel; GQA's
go through ``sdpa_ref`` with an additive mask. Sliding-window attention
is not ported (no configuration sets it).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..kernels.flash_attn.ops import flash_attention
from ..kernels.flash_attn.ref import sdpa_ref
from .config import ModelConfig
from .layers import (F32, NEG, RMSNorm, apply_rope, dense_init_,
                     matmul_heads, rmsnorm, _weight)

_LATER = "see ROADMAP.md, Queue 1 item 6"


class GQA(nn.Module):
    """``wq`` (d, h, hd), ``wk``/``wv`` (d, kv, hd), ``wo`` (h, hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        self.wq = _weight((d, h, hd), dtype, device)
        self.wk = _weight((d, kv, hd), dtype, device)
        self.wv = _weight((d, kv, hd), dtype, device)
        self.wo = _weight((h, hd, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        for n in ("wq", "wk", "wv", "wo"):
            dense_init_(getattr(self, n), gen)


class KVCache(NamedTuple):
    k: torch.Tensor  # (b, s_max, kv, hd)
    v: torch.Tensor  # (b, s_max, kv, hd)


def _qkv(p: GQA, cfg: ModelConfig, x, positions):
    q = apply_rope(matmul_heads(x, p.wq), positions, cfg.rope_theta)
    k = apply_rope(matmul_heads(x, p.wk), positions, cfg.rope_theta)
    v = matmul_heads(x, p.wv)
    return q, k, v


def _out(p, o: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)`` in the activations' type."""
    h, hd, d = p.wo.shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * hd),
                        p.wo.reshape(h * hd, d)).to(dtype)


def gqa_full_kv(p: GQA, cfg: ModelConfig, x, positions
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gqa_full` that also returns the roped K and V it attended
    over (prefill keeps them as the cache)."""
    if cfg.sliding_window:
        raise NotImplementedError(
            f"sliding-window attention is not ported yet ({_LATER})")
    q, k, v = _qkv(p, cfg, x, positions)
    o = flash_attention(q, k, v, causal=True)
    return _out(p, o, x.dtype), k, v


def gqa_full(p: GQA, cfg: ModelConfig, x, positions) -> torch.Tensor:
    """x: (b, s, d) → (b, s, d); causal full-sequence attention."""
    return gqa_full_kv(p, cfg, x, positions)[0]


def gqa_decode(p: GQA, cfg: ModelConfig, x, cache: KVCache, index: int
               ) -> Tuple[torch.Tensor, KVCache]:
    """x: (b, 1, d); ``index``: the position being written. The new row
    lands in ``cache`` in place; returns ``(out, cache)``."""
    b = x.shape[0]
    s_max = cache.k.shape[1]
    if not 0 <= index < s_max:
        raise IndexError(f"decode index {index} outside a cache of "
                         f"{s_max} rows")
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, pos)
    cache.k[:, index:index + 1] = k
    cache.v[:, index:index + 1] = v
    kpos = torch.arange(s_max, device=x.device)[None, :]
    mask = torch.where(kpos <= index, 0.0, NEG).to(F32)
    o = sdpa_ref(q, cache.k, cache.v, causal=False, mask=mask)
    return _out(p, o, x.dtype), cache


def gqa_decode_packed(p: GQA, cfg: ModelConfig, x, cache: KVCache,
                      indices: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """x: (b, 1, d); ``indices``: (b,) int on x's device, the position row
    r writes and attends at (continuous batching: every slot is at its own
    depth; idle rows park on a scratch row no real query attends to).
    Each row's K/V lands in ``cache`` in place; returns ``(out, cache)``.
    Indices are not checked here (that would cost a host sync): the
    scheduler that builds them keeps them inside the cache."""
    b = x.shape[0]
    s_max = cache.k.shape[1]
    indices = indices.to(torch.int64)
    q, k, v = _qkv(p, cfg, x, indices[:, None])
    rows = torch.arange(b, device=x.device)
    cache.k[rows, indices] = k[:, 0]
    cache.v[rows, indices] = v[:, 0]
    kpos = torch.arange(s_max, device=x.device)[None, :]
    mask = torch.where(kpos <= indices[:, None], 0.0, NEG).to(F32)
    o = sdpa_ref(q, cache.k, cache.v, causal=False,
                 mask=mask[:, None, None, None, :])
    return _out(p, o, x.dtype), cache


def gqa_chunk_append(p: GQA, cfg: ModelConfig, x, cache: KVCache,
                     start: int) -> Tuple[torch.Tensor, KVCache]:
    """x: (b, c, d) at absolute positions ``start..start+c``, shared by
    every row. The chunk's K/V fill cache rows ``[start, start+c)`` in
    place (earlier rows hold earlier chunks or reused prefix blocks) and
    its queries attend causally over the whole cache; returns
    ``(out, cache)``."""
    b, c, _ = x.shape
    s_max = cache.k.shape[1]
    if not (0 <= start and start + c <= s_max):
        raise IndexError(f"chunk rows [{start}, {start + c}) outside a "
                         f"cache of {s_max} rows")
    pos = start + torch.arange(c, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, pos[None, :].expand(b, c))
    cache.k[:, start:start + c] = k
    cache.v[:, start:start + c] = v
    kpos = torch.arange(s_max, device=x.device)[None, :]
    mask = torch.where(kpos <= pos[:, None], 0.0, NEG).to(F32)
    o = sdpa_ref(q, cache.k, cache.v, causal=False, mask=mask)
    return _out(p, o, x.dtype), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------
class MLA(nn.Module):
    """``wq_down`` (d, q_lora), ``q_norm``, ``wq_up`` (q_lora, h,
    nope + rope), ``wkv_down`` (d, kv_lora + rope), ``kv_norm``, ``wk_up``
    (kv_lora, h, nope), ``wv_up`` (kv_lora, h, v_head), ``wo`` (h,
    v_head, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.wq_down = _weight((d, qr), dtype, device)
        self.q_norm = RMSNorm(qr, dtype, device)
        self.wq_up = _weight((qr, h, nope + rope), dtype, device)
        self.wkv_down = _weight((d, kr + rope), dtype, device)
        self.kv_norm = RMSNorm(kr, dtype, device)
        self.wk_up = _weight((kr, h, nope), dtype, device)
        self.wv_up = _weight((kr, h, vd), dtype, device)
        self.wo = _weight((h, vd, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        for n in ("wq_down", "wq_up", "wkv_down", "wk_up", "wv_up", "wo"):
            dense_init_(getattr(self, n), gen)


class MLACache(NamedTuple):
    latent: torch.Tensor  # (b, s_max, kv_lora)
    k_rope: torch.Tensor  # (b, s_max, rope_dim)


def _mla_qkv_full(p: MLA, cfg: ModelConfig, x, positions):
    """→ (q_nope (b, s, h, nope), q_rope (b, s, h, rope) roped, latent
    (b, s, kv_lora) normed, k_rope (b, s, 1, rope) roped)."""
    nope, kr = cfg.qk_nope_dim, cfg.kv_lora_rank
    ql = rmsnorm(p.q_norm.scale, torch.matmul(x, p.wq_down), cfg.norm_eps)
    q = matmul_heads(ql, p.wq_up)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kvl = torch.matmul(x, p.wkv_down)
    latent = rmsnorm(p.kv_norm.scale, kvl[..., :kr], cfg.norm_eps)
    k_rope = apply_rope(kvl[..., None, kr:], positions, cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope


def mla_full_cache(p: MLA, cfg: ModelConfig, x, positions
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`mla_full` that also returns the normed latent and the roped
    key it attended over, (b, s, kv_lora) and (b, s, rope) (prefill keeps
    them as the cache)."""
    b, s, _ = x.shape
    h, rope = cfg.num_heads, cfg.qk_rope_dim
    q_nope, q_rope, latent, k_rope = _mla_qkv_full(p, cfg, x, positions)
    k_nope = matmul_heads(latent, p.wk_up)
    v = matmul_heads(latent, p.wv_up)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
    o = flash_attention(q, k, v, causal=True)
    return _out(p, o, x.dtype), latent, k_rope[:, :, 0]


def mla_full(p: MLA, cfg: ModelConfig, x, positions) -> torch.Tensor:
    """x: (b, s, d) → (b, s, d); the latent expanded to per-head K/V and
    attended causally by the flash-attention kernel."""
    return mla_full_cache(p, cfg, x, positions)[0]


def _mla_absorbed_attend(p: MLA, cfg: ModelConfig, q_nope, q_rope,
                         cl, cr, mask) -> torch.Tensor:
    """Absorbed-projection attention against the latent cache: ``wk_up``
    folds into the query and ``wv_up`` into the output, so scores and
    values stay in latent space. ``mask`` (f32, additive) broadcasts
    against the scores (b, h, s, t)."""
    dt = q_nope.dtype
    # scores in f32 from operands in the activations' type, as the
    # reference accumulates them
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.wk_up)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.to(F32), cl.to(F32))
              + torch.einsum("bshk,btk->bhst", q_rope.to(F32), cr.to(F32)))
    scale = 1.0 / torch.sqrt(torch.tensor(cfg.qk_nope_dim + cfg.qk_rope_dim,
                                          dtype=F32))
    probs = torch.softmax(scores * scale + mask, dim=-1).to(dt)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, cl)
    o = torch.einsum("bshr,rhk->bshk", ctx_lat, p.wv_up)
    return _out(p, o, dt)


def mla_decode(p: MLA, cfg: ModelConfig, x, cache: MLACache, index: int
               ) -> Tuple[torch.Tensor, MLACache]:
    """x: (b, 1, d); ``index``: the position being written. The latent and
    roped-key rows land in ``cache`` in place; returns ``(out, cache)``."""
    b = x.shape[0]
    s_max = cache.latent.shape[1]
    if not 0 <= index < s_max:
        raise IndexError(f"decode index {index} outside a cache of "
                         f"{s_max} rows")
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv_full(p, cfg, x, pos)
    cache.latent[:, index:index + 1] = latent
    cache.k_rope[:, index:index + 1] = k_rope[:, :, 0]
    kpos = torch.arange(s_max, device=x.device)[None, :]
    mask = torch.where(kpos <= index, 0.0, NEG).to(F32)
    return _mla_absorbed_attend(p, cfg, q_nope, q_rope, cache.latent,
                                cache.k_rope, mask), cache


def mla_decode_packed(p: MLA, cfg: ModelConfig, x, cache: MLACache,
                      indices: torch.Tensor) -> Tuple[torch.Tensor, MLACache]:
    """x: (b, 1, d); ``indices``: (b,) int on x's device, the position row
    r writes and attends at (unchecked, as in :func:`gqa_decode_packed`).
    Each row's latent and roped key land in ``cache`` in place."""
    b = x.shape[0]
    s_max = cache.latent.shape[1]
    indices = indices.to(torch.int64)
    q_nope, q_rope, latent, k_rope = _mla_qkv_full(p, cfg, x,
                                                   indices[:, None])
    rows = torch.arange(b, device=x.device)
    cache.latent[rows, indices] = latent[:, 0]
    cache.k_rope[rows, indices] = k_rope[:, 0, 0]
    kpos = torch.arange(s_max, device=x.device)[None, :]
    mask = torch.where(kpos <= indices[:, None], 0.0, NEG).to(F32)
    return _mla_absorbed_attend(p, cfg, q_nope, q_rope, cache.latent,
                                cache.k_rope, mask[:, None, None, :]), cache


def mla_chunk_append(p: MLA, cfg: ModelConfig, x, cache: MLACache,
                     start: int) -> Tuple[torch.Tensor, MLACache]:
    """x: (b, c, d) at absolute positions ``start..start+c``, shared by
    every row. The chunk's latent and roped-key rows fill cache rows
    ``[start, start+c)`` in place and its queries attend causally over the
    whole cache in latent space; returns ``(out, cache)``."""
    b, c, _ = x.shape
    s_max = cache.latent.shape[1]
    if not (0 <= start and start + c <= s_max):
        raise IndexError(f"chunk rows [{start}, {start + c}) outside a "
                         f"cache of {s_max} rows")
    pos = start + torch.arange(c, dtype=torch.int32, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv_full(
        p, cfg, x, pos[None, :].expand(b, c))
    cache.latent[:, start:start + c] = latent
    cache.k_rope[:, start:start + c] = k_rope[:, :, 0]
    kpos = torch.arange(s_max, device=x.device)[None, :]
    mask = torch.where(kpos <= pos[:, None], 0.0, NEG).to(F32)
    return _mla_absorbed_attend(p, cfg, q_nope, q_rope, cache.latent,
                                cache.k_rope, mask), cache
