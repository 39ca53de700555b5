"""Model assembly: ``embed → layers → final_norm → lm_head``.

:class:`Model` holds one :class:`Block` per layer in an ``nn.ModuleList``
(the reference stacks them on a leading ``layers`` axis and scans;
``convert.params_from_numpy`` unstacks). Four serving modes share the
layer definition:

* :meth:`Model.prefill`            — full sequence, returns last-position
  logits and the caches;
* :meth:`Model.decode_step`        — one token against the caches;
* :meth:`Model.decode_step_packed` — one token per row, each row at its
  own position (the continuous-batching scheduler's packed slot table);
* :meth:`Model.prefill_chunk`      — a chunk of prompt at absolute
  positions ``start..start+c`` against caches that hold the rows before.

Caches keep the reference's layout: a list with one :class:`KVCache` per
slot of ``layer_pattern``, each tensor stacked over layers,
``(num_layers, b, s, kv, hd)``. The three cache modes write into them in
place; :func:`pad_caches` always returns fresh storage, which is what keeps
values held by the prefix cache's pool unmutated.

The port runs the ``("attn",)`` pattern with a dense FFN (GQA models such
as llama3.2-3b). MLA, MoE, SSM, the modality frontends and training raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..core.table_torch import resolve_device
from . import attention as attn
from .attention import KVCache
from .config import ModelConfig
from .layers import (FFN, Embed, RMSNorm, ffn_apply, lm_logits, rmsnorm,
                     torch_dtype)

_LATER = "see ROADMAP.md, Queue 1"


def _check_supported(cfg: ModelConfig) -> None:
    what = None
    if any(k != "attn" for k in cfg.layer_pattern):
        what = f"layer_pattern {cfg.layer_pattern} (SSM / hybrid stacks)"
    elif cfg.attn_type != "gqa":
        what = f"attn_type {cfg.attn_type!r}"
    elif any(f != "dense" for f in cfg.ffn_pattern):
        what = f"ffn_pattern {cfg.ffn_pattern} (MoE)"
    elif cfg.frontend != "none":
        what = f"frontend {cfg.frontend!r}"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet ({_LATER})")


class Block(nn.Module):
    """One layer: ``mixer_ln → mixer (GQA) → ffn_ln → ffn``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.mixer_ln = RMSNorm(cfg.d_model, dtype, device)
        self.mixer = attn.GQA(cfg, dtype, device)
        self.ffn_ln = RMSNorm(cfg.d_model, dtype, device)
        self.ffn = FFN(cfg, dtype, device)


class Model(nn.Module):
    """A decoder-only LM on ``device`` (the card unless ``"cpu"`` is
    asked for), its weights drawn from ``seed`` with a
    ``torch.Generator`` on that device, one tensor at a time, from the
    reference's distributions (N(0, 1)/sqrt(fan_in) matrices, embedding
    N(0, 0.02²), norm scales 1). The draws are not JAX's: parity with the
    reference goes through ``load_state_dict(params_from_numpy(...))``."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.embed = Embed(cfg, dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, dtype, dev)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            self.embed.init_(gen)
            for blk in self.layers:
                blk.mixer.init_(gen)
                blk.ffn.init_(gen)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def dtype(self) -> torch.dtype:
        return self.final_norm.scale.dtype

    # -- serving -------------------------------------------------------------
    def _ffn(self, blk: Block, x):
        return x + ffn_apply(blk.ffn, self.cfg,
                             rmsnorm(blk.ffn_ln.scale, x, self.cfg.norm_eps))

    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, List[KVCache]]:
        """tokens: (b, s) → (logits (b, 1, V) f32 at the last position,
        caches sized to s)."""
        cfg = self.cfg
        x = self.embed(tokens)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :]
        ks, vs = [], []
        for blk in self.layers:
            h = rmsnorm(blk.mixer_ln.scale, x, cfg.norm_eps)
            mix, k, v = attn.gqa_full_kv(blk.mixer, cfg, h, positions)
            x = self._ffn(blk, x + mix)
            ks.append(k)
            vs.append(v)
        x = rmsnorm(self.final_norm.scale, x, cfg.norm_eps)
        logits = lm_logits(self.embed, cfg, x[:, -1:, :])
        return logits, [KVCache(torch.stack(ks), torch.stack(vs))]

    def _over_caches(self, tokens: torch.Tensor, caches: List[KVCache],
                     mixer) -> Tuple[torch.Tensor, List[KVCache]]:
        """Every layer with ``mixer(gqa, cfg, h, layer_cache)`` as its
        token mixer, which writes its K/V rows into the layer's cache in
        place → (logits (b, s, V) f32 at every position, caches)."""
        cfg = self.cfg
        x = self.embed(tokens)
        (c,) = caches
        for i, blk in enumerate(self.layers):
            h = rmsnorm(blk.mixer_ln.scale, x, cfg.norm_eps)
            mix, _ = mixer(blk.mixer, cfg, h, KVCache(c.k[i], c.v[i]))
            x = self._ffn(blk, x + mix)
        x = rmsnorm(self.final_norm.scale, x, cfg.norm_eps)
        return lm_logits(self.embed, cfg, x), caches

    def decode_step(self, tokens: torch.Tensor, caches: List[KVCache],
                    index: int) -> Tuple[torch.Tensor, List[KVCache]]:
        """tokens: (b, 1) at position ``index`` → (logits (b, 1, V) f32,
        caches). The K/V rows are written into ``caches`` in place."""
        return self._over_caches(
            tokens, caches,
            lambda p, cfg, h, c: attn.gqa_decode(p, cfg, h, c, index))

    def decode_step_packed(self, tokens: torch.Tensor,
                           caches: List[KVCache], indices: torch.Tensor
                           ) -> Tuple[torch.Tensor, List[KVCache]]:
        """tokens: (b, 1); ``indices``: (b,) int on the model's device, row
        r's position → (logits (b, 1, V) f32, caches). Each row's K/V is
        written into ``caches`` in place at its own index."""
        return self._over_caches(
            tokens, caches,
            lambda p, cfg, h, c: attn.gqa_decode_packed(p, cfg, h, c,
                                                        indices))

    def prefill_chunk(self, tokens: torch.Tensor, caches: List[KVCache],
                      start: int) -> Tuple[torch.Tensor, List[KVCache]]:
        """tokens: (b, c) at absolute positions ``start..start+c`` against
        caches whose rows below ``start`` already hold the prefix →
        (logits (b, c, V) f32, caches), the chunk's K/V written in place.
        Attention-only stacks: an SSM's recurrent state cannot be entered
        mid-sequence."""
        if any(k == "ssm" for k in self.cfg.layer_pattern):
            raise ValueError(
                f"prefill_chunk requires a pure-attention stack; "
                f"{self.cfg.name} has layer_pattern="
                f"{self.cfg.layer_pattern}")
        return self._over_caches(
            tokens, caches,
            lambda p, cfg, h, c: attn.gqa_chunk_append(p, cfg, h, c, start))

    # -- not ported yet ------------------------------------------------------
    def forward_train(self, *args, **kwargs):
        raise NotImplementedError(f"training is not ported yet ({_LATER})")

    def loss_fn(self, *args, **kwargs):
        raise NotImplementedError(f"training is not ported yet ({_LATER})")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype,
                device="cuda") -> List[KVCache]:
    """Zero caches, ``(num_layers, batch, s_max, kv, hd)`` per tensor."""
    _check_supported(cfg)
    shape = (cfg.num_groups, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return [KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))]


def pad_caches(cfg: ModelConfig, caches: List[KVCache],
               new_len: int) -> List[KVCache]:
    """Copies of ``caches`` with the sequence axis grown to ``new_len``
    (never shrunk; zero rows appended). Always fresh storage, even when
    nothing grows: decode writes into what this returns."""
    out = []
    for kind, c in zip(cfg.layer_pattern, caches):
        if kind == "attn":
            def grow(x):
                shape = list(x.shape)
                shape[2] = max(new_len, x.shape[2])
                y = x.new_zeros(shape)
                y[:, :, :x.shape[2]] = x
                return y
            c = KVCache(grow(c.k), grow(c.v))
        out.append(c)
    return out
