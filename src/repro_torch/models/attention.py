"""GQA token mixer (+RoPE) in full-sequence and decode modes.

* ``gqa_full`` — prefill over the whole sequence (causal). Its attention
  is the flash-attention kernel (``kernels/flash_attn``) under either
  ``attn_impl``: the reference's dense ``_sdpa`` and chunked
  ``_sdpa_chunked`` compute the same function, which is the kernel's.
* ``gqa_decode`` — one new token against a KV cache, through the
  kernel's plain version ``sdpa_ref`` with an additive mask (the
  reference runs it outside any Pallas kernel too). It
  writes the new K/V row into the cache **in place**; callers hand it
  caches they own (``model.pad_caches`` always returns fresh storage).
* ``gqa_decode_packed`` — one token per row of a packed slot table, each
  row at its own position: a per-row write and a per-row (b, t) mask.
* ``gqa_chunk_append`` — a chunk of prefill at absolute positions
  ``start..start+c`` written into the cache in place and attended
  causally over the whole cache.

The three cache modes attend through ``sdpa_ref`` with an additive mask,
as the reference computes them with jnp ``_sdpa`` outside any Pallas
kernel. Sliding-window attention and MLA are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..kernels.flash_attn.ops import flash_attention
from ..kernels.flash_attn.ref import sdpa_ref
from .config import ModelConfig
from .layers import F32, NEG, apply_rope, dense_init_, matmul_heads, _weight

_LATER = "see ROADMAP.md, Queue 1"


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


def _out(p: GQA, o: torch.Tensor, dtype) -> torch.Tensor:
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
