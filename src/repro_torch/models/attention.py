"""Attention token mixers: GQA (+RoPE, optional sliding window) and MLA
(MiniCPM3 / DeepSeek latent attention, with absorbed-projection decode).

* ``gqa_full`` / ``mla_full`` — the whole sequence (causal). For prefill
  its attention is the flash-attention kernel (``kernels/flash_attn``)
  under either ``attn_impl``: the reference's dense ``_sdpa`` and chunked
  ``_sdpa_chunked`` compute the same function, which is the kernel's.
  With ``train=True`` (``Model.forward_train``) it attends through
  :func:`_sdpa` or :func:`_sdpa_chunked`, by ``attn_impl``: plain,
  differentiable torch, as the reference trains through its jnp
  functions (neither package has a backward kernel). MLA expands its
  latent into per-head K/V first (d = nope + rope, dv = v_head, kvh = h).
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
go through ``sdpa_ref`` with an additive mask.

Sliding window (``cfg.sliding_window = w > 0``, GQA): query i keeps key j
iff ``i - w < j <= i``, the reference's ``_causal_mask(s, s, 0, w)``. It
is a mask over the reference's cache layout (``(b, s_max, kv, hd)``, every
row kept), not a rolling cache. Prefill launches the kernel with the
window (which skips the key tiles wholly before it), training takes it
in ``_sdpa`` / ``_sdpa_chunked`` as the reference's ``gqa_full`` does, and
every cache mode masks it too: decode at position t equals row t of the
reference's windowed ``gqa_full`` over tokens 0..t. The reference's own
decode, packed and chunk modes mask only ``kpos <= index`` and so attend
past the window its prefill keeps; the port departs from them there
(ROADMAP, Queue 3), and with ``w = 0`` every mode is the reference's.
MLA has no window in any mode, as the reference's dense ``mla_full`` and
its MLA cache modes have none (its chunked ``mla_full`` reads the window
through ``_sdpa_chunked``; the port follows the dense form, so a
windowed MLA stack prefills and decodes alike).

The head projections run in the activations' type (the reference's f32
result, cast at once). The output projection ``wo`` sums in f32 before
its cast (row-parallel partials too), except ``gqa_full``'s under
``opt_bf16_grads``, which the reference takes in the activations' type;
the decode, packed, chunk and MLA modes keep f32 there, as the
reference does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels.flash_attn import kernel as flash_kernel
from ..kernels.flash_attn.ref import sdpa_ref
from . import sharding_hints

try:   # simulated ranks (LocalTensorMode) run a kernel once a rank
    from torch.distributed._local_tensor import maybe_run_for_local_tensor
except ImportError:                                  # pragma: no cover
    def maybe_run_for_local_tensor(fn):
        return fn
from .config import ModelConfig
from .layers import (F32, NEG, RMSNorm, apply_rope, bf16_grad_boundary,
                     dense_init_, matmul_heads, matmul_rows, rmsnorm,
                     _weight)
from .sharding_hints import grad_in_f32

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


def axes_gqa():
    return {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


class KVCache(NamedTuple):
    k: torch.Tensor  # (b, s_max, kv, hd)
    v: torch.Tensor  # (b, s_max, kv, hd)


def kv_cache_axes() -> KVCache:
    return KVCache(k=("batch", "seq", "kv_heads", "head_dim"),
                   v=("batch", "seq", "kv_heads", "head_dim"))


def _qkv(p: GQA, cfg: ModelConfig, x, positions):
    if not cfg.opt_bf16_grads:
        x = grad_in_f32(x)
    q = apply_rope(matmul_heads(x, p.wq), positions, cfg.rope_theta)
    k = apply_rope(matmul_heads(x, p.wk), positions, cfg.rope_theta)
    v = matmul_heads(x, p.wv)
    return q, k, v


def _out(p, o: torch.Tensor, dtype, reduce_f32: bool = True
         ) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)`` in the activations' type; with
    DTensors, row-parallel on each rank's heads (``matmul_rows``), the
    partials summed in f32 unless ``reduce_f32`` is off."""
    return matmul_rows(o, p.wo, reduce_f32).to(dtype)


def _keep(kpos, qpos, window: int = 0) -> torch.Tensor:
    """Whether a query at ``qpos`` attends to a key at ``kpos``
    (broadcast): ``qpos - window < kpos <= qpos``, with no lower edge
    when ``window`` is 0."""
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def _mask(kpos, qpos, window: int = 0) -> torch.Tensor:
    """:func:`_keep` as an additive f32 mask: 0 or ``NEG``."""
    return torch.where(_keep(kpos, qpos, window), 0.0, NEG).to(F32)


def _causal_mask(s: int, device, window: int = 0) -> torch.Tensor:
    """(s, s) additive f32 mask: 0 where ``query - window < key <=
    query``, else ``NEG``: the reference's ``_causal_mask(s, s, 0,
    window)``."""
    pos = torch.arange(s, device=device)
    return _mask(pos[None, :], pos[:, None], window)


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """The reference's dense ``_sdpa``, differentiable: q (b, s, h, dq),
    k (b, t, kvh, dq), v (b, t, kvh, dv), ``mask`` additive f32 (s, t) →
    (b, s, h, dv) in ``q.dtype``. Scores from the inputs' products summed
    in f32, the softmax in f32, probabilities cast to ``q.dtype``, the PV
    product summed in f32. k and v may come widened to f32 (holding
    q-type values, :func:`_on_local_heads`): their gradients then stay
    f32."""
    b, s, h, dq = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    qr = q.reshape(b, s, kvh, h // kvh, dq)
    scale = 1.0 / torch.sqrt(torch.tensor(dq, dtype=F32))
    scores = torch.einsum("bskgd,btkd->bkgst", qr.to(F32), k.to(F32))
    probs = torch.softmax(scores * scale + mask, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(F32), v.to(F32))
    return out.reshape(b, s, h, dv).to(q.dtype)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, window: int = 0
                  ) -> torch.Tensor:
    """The reference's ``_sdpa_chunked``, differentiable: causal attention
    (within ``window`` keys when it is > 0) by online softmax over
    (``attn_q_chunk`` x ``attn_kv_chunk``) tiles, with :func:`_sdpa`'s
    rounding steps. A key tile wholly after a query tile is skipped: in
    the reference it adds exactly 0 (its probabilities are
    ``exp(-1e30 - m) = 0`` and its rescale 1). So is a key tile wholly
    before every row's window: in the reference such a tile finds each
    row's running max still at -1e30 and adds p = 1 a key, which the
    first tile with a kept key wipes out exactly (its rescale is
    ``exp(-1e30 - m) = 0``)."""
    b, s, h, dq = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    g = h // kvh
    qc, kc = min(cfg.attn_q_chunk, s), min(cfg.attn_kv_chunk, s)
    if s % qc or s % kc:
        raise ValueError(f"seq {s} is not a multiple of the chunks "
                         f"({qc}, {kc})")
    scale = 1.0 / torch.sqrt(torch.tensor(dq, dtype=F32))
    qr = q.reshape(b, s // qc, qc, kvh, g, dq).to(F32)
    kr = k.reshape(b, s // kc, kc, kvh, dq).to(F32)
    vr = v.reshape(b, s // kc, kc, kvh, dv)
    pos = torch.arange(s, device=q.device)
    chunks = []
    for qi in range(s // qc):
        q_last = (qi + 1) * qc - 1
        q_pos = pos[qi * qc:q_last + 1]
        q_first = qi * qc
        m = torch.full((b, kvh, g, qc), NEG, dtype=F32, device=q.device)
        l = torch.zeros((b, kvh, g, qc), dtype=F32, device=q.device)
        acc = torch.zeros((b, kvh, g, qc, dv), dtype=F32, device=q.device)
        for ki in range(s // kc):
            if ki * kc > q_last:
                break
            if window and (ki + 1) * kc - 1 <= q_first - window:
                continue
            k_pos = pos[ki * kc:(ki + 1) * kc]
            scores = torch.einsum("bqkgd,btkd->bkgqt", qr[:, qi],
                                  kr[:, ki]) * scale
            ok = _keep(k_pos[None, :], q_pos[:, None], window)
            scores = torch.where(ok, scores, NEG)
            m_new = torch.maximum(m, scores.amax(-1))
            pr = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", pr.to(q.dtype).to(F32),
                vr[:, ki].to(F32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        chunks.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, dv)
                      .to(q.dtype))
    return torch.cat(chunks, dim=1)


def _attend(q, k, v, cfg: ModelConfig, train: bool, window: int = 0
            ) -> torch.Tensor:
    """Causal attention over the whole sequence (within ``window`` keys
    when it is > 0): the flash-attention kernel for prefill; the
    reference's differentiable jnp functions, by ``attn_impl``, for
    training. DTensor heads attend shard by shard
    (:func:`_on_local_heads`)."""
    return _on_local_heads(_attend_shard, q, k, v, cfg, train, window)


def _attend_shard(q, k, v, cfg: ModelConfig, train: bool, window: int
                  ) -> torch.Tensor:
    if train:
        if cfg.attn_impl == "chunked":
            return _sdpa_chunked(q, k, v, cfg, window)
        return _sdpa(q, k, v, _causal_mask(q.shape[1], q.device, window))
    if is_fake(q):
        # a dry-run traces fake tensors, which no kernel can read: it
        # counts the dense attention the kernel computes (what that
        # allocates is what its flash-projected bytes leave out)
        with flash_kernel.standing_in():
            return _sdpa(q, k, v, _causal_mask(q.shape[1], q.device,
                                               window))
    return _flash_shard(q.contiguous(), k.contiguous(), v.contiguous(),
                        window)


@maybe_run_for_local_tensor
def _flash_shard(q, k, v, window):
    # a simulated rank set (LocalTensorMode) launches the kernel once a
    # rank; the reference's ops.flash_attention has no window, so the
    # windowed launch goes through the kernel's wrapper
    return flash_kernel.flash_attention_fwd(q, k, v, causal=True,
                                            window=window)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: a local shard's
    gradient goes back into a DTensor whose next backward op (a ``view``
    in a matmul's backward) takes its global layout as the local one's."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_local_heads(fn, q, k, v, *args):
    """``fn(q, k, v, *args)`` (attention over (b, s, heads, dim) tensors);
    with DTensor inputs, on each rank's local heads through ``local_map``:
    q and the output split on heads by the hint rules' ``heads`` dims, k
    and v on their own heads (``kv_heads``, or ``heads`` when every query
    head has its own), the batch on ``batch``; a key axis split over
    ranks (sequence-sharded decode caches) is gathered first. Each rank
    then computes what the unsharded call computes on its heads: query
    head j reads local KV head j // (local group), which is its global
    KV head when a rank holds one KV head or the whole of each group
    (``plan_for`` gives no other case). Where a KV head is whole on ranks
    that split its query heads, K's and V's gradients are partial sums
    over those ranks: K and V enter widened (``grad_in_f32``), so the
    sums are taken in f32, as the reference sums the transposes of its
    f32-result score and PV products. Plain tensors run ``fn`` as they
    are."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, *args)
    mesh = q.device_mesh
    ctx = sharding_hints.active()
    kv_name = "heads" if k.shape[2] == q.shape[2] else "kv_heads"
    if ctx is None:
        qp = kp = tuple(Replicate() for _ in mesh.mesh_dim_names)
    else:
        qp = sharding_hints.fitting(q.shape, mesh, sharding_hints.placements_for(
            mesh, ctx.rules, ("batch", None, "heads", None)))
        kp = sharding_hints.fitting(k.shape, mesh, sharding_hints.placements_for(
            mesh, ctx.rules, ("batch", None, kv_name, None)))
    ways = [math.prod(mesh.size(i) for i, pl in enumerate(pls)
                      if pl == Shard(2)) for pls in (qp, kp)]
    if k.shape[2] // ways[1] > 1 and ways[0] != ways[1]:
        raise ValueError(f"heads split {ways[0]} ways over {q.shape[2]} "
                         f"query heads and {ways[1]} over {k.shape[2]} KV "
                         f"heads: a rank's query heads would not read "
                         f"their own KV heads")
    if any(b == Replicate() and isinstance(a, Shard)
           for a, b in zip(qp, kp)):
        k, v = grad_in_f32(k), grad_in_f32(v)
    def local(q, k, v, *a):
        return fn(*(_ContiguousGrad.apply(t) for t in (q, k, v)), *a)

    return sharding_hints.run_local(local, mesh, qp,
                                    (qp, kp, kp) + (None,) * len(args),
                                    q, k, v, *args)


def gqa_full_kv(p: GQA, cfg: ModelConfig, x, positions, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gqa_full` that also returns the roped K and V it attended
    over (prefill keeps them as the cache)."""
    if cfg.opt_bf16_grads:
        x = bf16_grad_boundary(x)
    q, k, v = _qkv(p, cfg, x, positions)
    o = _attend(q, k, v, cfg, train, cfg.sliding_window)
    return _out(p, o, x.dtype, not cfg.opt_bf16_grads), k, v


def gqa_full(p: GQA, cfg: ModelConfig, x, positions,
             train: bool = False) -> torch.Tensor:
    """x: (b, s, d) → (b, s, d); causal full-sequence attention, within
    ``cfg.sliding_window`` keys when it is > 0 (the training form with
    ``train=True``)."""
    return gqa_full_kv(p, cfg, x, positions, train)[0]


def _write_row(buf: torch.Tensor, row: torch.Tensor, index: int) -> None:
    """``buf[:, index] = row[:, 0]``, in place. A DTensor cache split on
    its sequence dim takes it as a masked copy: a slice write into it
    does not land on the rank that holds the row."""
    if not (isinstance(buf, DTensor) and Shard(1) in buf.placements):
        buf[:, index:index + 1] = row
        return
    pos = torch.arange(buf.shape[1], device=buf.device)
    at = (pos == index).reshape(1, -1, *([1] * (buf.ndim - 2)))
    buf.copy_(torch.where(at, row, buf))


def _masked(q, k, v, mask) -> torch.Tensor:
    return sdpa_ref(q, k, v, causal=False, mask=mask)


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
    _write_row(cache.k, k, index)
    _write_row(cache.v, v, index)
    kpos = torch.arange(s_max, device=x.device)[None, :]
    mask = _mask(kpos, index, cfg.sliding_window)
    o = _on_local_heads(_masked, q, cache.k, cache.v, mask)
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
    mask = _mask(kpos, indices[:, None], cfg.sliding_window)
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
    mask = _mask(kpos, pos[:, None], cfg.sliding_window)
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


def axes_mla():
    return {"wq_down": ("embed", "q_lora"),
            "q_norm": {"scale": ("q_lora",)},
            "wq_up": ("q_lora", "heads", "head_dim"),
            "wkv_down": ("embed", "kv_lora_rope"),
            "kv_norm": {"scale": ("kv_lora",)},
            "wk_up": ("kv_lora", "heads", "head_dim"),
            "wv_up": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


class MLACache(NamedTuple):
    latent: torch.Tensor  # (b, s_max, kv_lora)
    k_rope: torch.Tensor  # (b, s_max, rope_dim)


def mla_cache_axes() -> MLACache:
    return MLACache(latent=("batch", "seq", "kv_lora"),
                    k_rope=("batch", "seq", None))


def _mla_qkv_full(p: MLA, cfg: ModelConfig, x, positions):
    """→ (q_nope (b, s, h, nope), q_rope (b, s, h, rope) roped, latent
    (b, s, kv_lora) normed, k_rope (b, s, 1, rope) roped)."""
    nope, kr = cfg.qk_nope_dim, cfg.kv_lora_rank
    # with DTensor weights the down projections too take their weights'
    # gradients as the reference does (matmul_heads)
    down = matmul_heads if isinstance(p.wq_down, DTensor) else torch.matmul
    ql = rmsnorm(p.q_norm.scale, down(x, p.wq_down), cfg.norm_eps)
    q = matmul_heads(grad_in_f32(ql), p.wq_up)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kvl = down(x, p.wkv_down)
    latent = rmsnorm(p.kv_norm.scale, kvl[..., :kr], cfg.norm_eps)
    k_rope = apply_rope(kvl[..., None, kr:], positions, cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope


def mla_full_cache(p: MLA, cfg: ModelConfig, x, positions,
                   train: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`mla_full` that also returns the normed latent and the roped
    key it attended over, (b, s, kv_lora) and (b, s, rope) (prefill keeps
    them as the cache)."""
    b, s, _ = x.shape
    h, rope = cfg.num_heads, cfg.qk_rope_dim
    q_nope, q_rope, latent, k_rope = _mla_qkv_full(p, cfg, x, positions)
    lat = grad_in_f32(latent)
    k_nope = matmul_heads(lat, p.wk_up)
    v = matmul_heads(lat, p.wv_up)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
    o = _attend(q, k, v, cfg, train)
    return _out(p, o, x.dtype), latent, k_rope[:, :, 0]


def mla_full(p: MLA, cfg: ModelConfig, x, positions,
             train: bool = False) -> torch.Tensor:
    """x: (b, s, d) → (b, s, d); the latent expanded to per-head K/V and
    attended causally by the flash-attention kernel (by the training
    attention with ``train=True``); no sliding window (see the module
    docstring)."""
    return mla_full_cache(p, cfg, x, positions, train)[0]


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
    _write_row(cache.latent, latent, index)
    _write_row(cache.k_rope, k_rope[:, :, 0], index)
    kpos = torch.arange(s_max, device=x.device)[None, :]
    return _mla_absorbed_attend(p, cfg, q_nope, q_rope, cache.latent,
                                cache.k_rope, _mask(kpos, index)), cache


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
    mask = _mask(kpos, indices[:, None])[:, None, None, :]
    return _mla_absorbed_attend(p, cfg, q_nope, q_rope, cache.latent,
                                cache.k_rope, mask), cache


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
    return _mla_absorbed_attend(p, cfg, q_nope, q_rope, cache.latent,
                                cache.k_rope, _mask(kpos, pos[:, None])), cache
