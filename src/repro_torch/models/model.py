"""Model assembly: ``embed → layers → final_norm → lm_head``.

:class:`Model` holds one :class:`Block` per layer in an ``nn.ModuleList``.
Layer ``g · G + slot`` (G = ``len(layer_pattern)``) is group ``g``'s slot
``slot``: an ``attn`` (GQA or MLA, by ``attn_type``) or ``ssm`` token
mixer, then a ``dense``, ``moe`` or ``none`` channel mixer. The reference
stacks each slot's layers on a leading axis and scans over groups;
``convert.params_from_numpy`` unstacks. Four serving modes share the
layer definition:

* :meth:`Model.prefill`            — full sequence, returns last-position
  logits and the caches;
* :meth:`Model.decode_step`        — one token against the caches;
* :meth:`Model.decode_step_packed` — one token per row, each row at its
  own position (the continuous-batching scheduler's packed slot table);
  SSM decode is position-free, so it is packed by nature (idle rows
  included, as in the reference);
* :meth:`Model.prefill_chunk`      — a chunk of prompt at absolute
  positions ``start..start+c`` against caches that hold the rows before
  (attention-only stacks).

Caches keep the reference's layout: a list with one cache tuple per slot
of ``layer_pattern`` (:class:`~.attention.KVCache`,
:class:`~.attention.MLACache` or :class:`~.ssm.SSMCache`), each tensor
stacked over the groups, ``(num_groups, b, ...)``. The cache modes write
into them in place; :func:`pad_caches` always returns fresh storage, which
is what keeps values held by the prefix cache's pool unmutated.

The modality stubs (``vision_stub``, ``audio_stub``) take precomputed
embeddings, ``frontend_embeds`` (b, num_patches, d), which replace the
first ``num_patches`` positions of the token embeddings.

Training: :meth:`Model.forward_train` runs the whole sequence through
every layer with the training attention (``attention._sdpa`` or
``_sdpa_chunked``, by ``attn_impl``; never the forward-only kernel) and
returns f32 logits, the summed MoE aux loss and expert counts;
:meth:`Model.loss_fn` is the masked next-token cross entropy plus
``aux_coef · aux``. With ``remat`` each group of ``len(layer_pattern)``
layers is recomputed in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps each
group in ``jax.checkpoint(nothing_saveable)``. Parameters are created
with ``requires_grad=False`` (serving builds no graph); a trainer calls
``model.requires_grad_(True)``.

Sharding: :func:`param_axes` / :func:`cache_axes` name the logical axis
of every parameter and cache dim, keyed like the ``state_dict`` and the
caches (``launch/sharding.py`` maps them onto a mesh);
:func:`abstract_params` / :func:`abstract_caches` are their shapes and
dtypes on the ``meta`` device (``Model(cfg, device="meta")`` allocates
nothing and draws no weights). With DTensor parameters every mode runs
as it is; ``_group_train`` pins the residual stream and re-places the
group's weights where the reference's ``hint`` calls do
(``sharding_hints``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.checkpoint import checkpoint

from ..core.table_torch import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (F32, FFN, Embed, RMSNorm, axes_embed, axes_ffn,
                     axes_rmsnorm, ffn_apply, lm_logits, rmsnorm,
                     torch_dtype)
from .sharding_hints import active, hint, param_hint_tree, run_local
MIXERS = ("attn", "ssm")
FFNS = ("dense", "moe", "none")
FRONTENDS = ("none", "vision_stub", "audio_stub")


def _check_supported(cfg: ModelConfig) -> None:
    """Refuse a layout no reference configuration can hold."""
    ok = (set(cfg.layer_pattern) <= set(MIXERS)
          and set(cfg.ffn_pattern) <= set(FFNS)
          and cfg.attn_type in ("gqa", "mla") and cfg.frontend in FRONTENDS)
    if not ok:
        raise ValueError(
            f"{cfg.name}: layer_pattern {cfg.layer_pattern}, ffn_pattern "
            f"{cfg.ffn_pattern}, attn_type {cfg.attn_type!r}, frontend "
            f"{cfg.frontend!r}: expected mixers in {MIXERS}, FFNs in "
            f"{FFNS}, attn_type gqa or mla, frontend in {FRONTENDS}")


def has_ssm(cfg: ModelConfig) -> bool:
    """Whether the stack holds an SSM layer (SSM or hybrid): its
    recurrent state is neither sliced by position nor entered
    mid-sequence, so serving prefills and caches whole prompts only."""
    return "ssm" in cfg.layer_pattern


class Block(nn.Module):
    """One layer: ``mixer_ln → mixer → [ffn_ln → ffn]``."""

    def __init__(self, cfg: ModelConfig, kind: str, ffn_kind: str, dtype,
                 device):
        super().__init__()
        self.kind = kind
        self.ffn_kind = ffn_kind
        self.mixer_ln = RMSNorm(cfg.d_model, dtype, device)
        if kind == "ssm":
            self.mixer = ssm_mod.SSM(cfg, dtype, device)
        elif cfg.attn_type == "mla":
            self.mixer = attn.MLA(cfg, dtype, device)
        else:
            self.mixer = attn.GQA(cfg, dtype, device)
        if ffn_kind != "none":
            self.ffn_ln = RMSNorm(cfg.d_model, dtype, device)
            self.ffn = (FFN(cfg, dtype, device) if ffn_kind == "dense"
                        else moe_mod.MoE(cfg, dtype, device))


class _Mode(NamedTuple):
    """One cache mode's token mixers, each ``(p, cfg, h, layer_cache) →
    (out, layer_cache)``."""
    gqa: object
    mla: object
    ssm: object


class Model(nn.Module):
    """A decoder-only LM on ``device`` (the card unless ``"cpu"`` is
    asked for), its weights drawn from ``seed`` with a
    ``torch.Generator`` on that device, one tensor at a time, from the
    reference's distributions (N(0, 1)/sqrt(fan_in) matrices, embedding
    N(0, 0.02²), norm scales 1, the SSM's own constants). The draws are
    not JAX's: parity with the reference goes through
    ``load_state_dict(params_from_numpy(...))``. On the ``meta`` device
    nothing is drawn."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        # a bf16 or f16 product is its f32 sum rounded once (the
        # reference's accumulation): cuBLAS may otherwise reduce split-K
        # partials in the operands' type. Process-wide, so every entry
        # point that builds a model runs with both cleared
        mm = torch.backends.cuda.matmul
        mm.allow_bf16_reduced_precision_reduction = False
        mm.allow_fp16_reduced_precision_reduction = False
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        G = cfg.group_size
        self.embed = Embed(cfg, dtype, dev)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.layer_pattern[i % G], cfg.ffn_pattern[i % G],
                  dtype, dev) for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype, dev)
        if dev.type == "meta":
            return
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            self.embed.init_(gen)
            for blk in self.layers:
                blk.mixer.init_(gen)
                if blk.ffn_kind != "none":
                    blk.ffn.init_(gen)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def dtype(self) -> torch.dtype:
        return self.final_norm.scale.dtype

    # -- layers --------------------------------------------------------------
    def _ffn(self, blk: Block, x):
        """Residual channel mixer → (x, aux, counts or None)."""
        if blk.ffn_kind == "none":
            return x, None, None
        h = rmsnorm(blk.ffn_ln.scale, x, self.cfg.norm_eps)
        if blk.ffn_kind == "dense":
            return x + ffn_apply(blk.ffn, self.cfg, h), None, None
        y, aux, counts = moe_mod.moe_apply(blk.ffn, self.cfg, h)
        return x + y, aux, counts

    def _embed(self, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        # a vocab-split lookup is a partial sum: reduce it once, in the
        # table's dtype, before anything widens it
        x = hint(self.embed(tokens), "batch", None, None)
        if self.cfg.frontend == "none":
            return x
        if frontend_embeds is None:
            raise ValueError(f"{self.cfg.name}: frontend "
                             f"{self.cfg.frontend!r} needs frontend_embeds "
                             f"(b, {self.cfg.num_patches}, d)")
        pe = frontend_embeds.to(x.dtype)
        return torch.cat([pe, x[:, pe.shape[1]:, :]], dim=1)

    # -- serving -------------------------------------------------------------
    def prefill(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, list]:
        """tokens: (b, s) [+ ``frontend_embeds`` (b, num_patches, d) for
        the stubs] → (logits (b, 1, V) f32 at the last position, caches
        sized to s)."""
        cfg = self.cfg
        x = self._embed(tokens, frontend_embeds)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :]
        per_slot: List[list] = [[] for _ in range(cfg.group_size)]
        for i, blk in enumerate(self.layers):
            h = rmsnorm(blk.mixer_ln.scale, x, cfg.norm_eps)
            if blk.kind == "ssm":
                mix, cache = ssm_mod.ssd_full(blk.mixer, cfg, h,
                                              return_cache=True)
            elif cfg.attn_type == "mla":
                mix, latent, k_rope = attn.mla_full_cache(blk.mixer, cfg, h,
                                                          positions)
                cache = attn.MLACache(latent, k_rope)
            else:
                mix, k, v = attn.gqa_full_kv(blk.mixer, cfg, h, positions)
                cache = attn.KVCache(k, v)
            x, _, _ = self._ffn(blk, hint(x + mix, "batch", None, None))
            x = hint(x, "batch", None, None)
            per_slot[i % cfg.group_size].append(cache)
        x = rmsnorm(self.final_norm.scale, x, cfg.norm_eps)
        logits = lm_logits(self.embed, cfg, x[:, -1:, :])
        return logits, [type(cs[0])(*(torch.stack(t) for t in zip(*cs)))
                        for cs in per_slot]

    def _over_caches(self, tokens: torch.Tensor, caches: list, mode: _Mode
                     ) -> Tuple[torch.Tensor, list]:
        """Every layer with its mode's mixer over its own views of the
        caches, which the mixer writes in place → (logits (b, s, V) f32 at
        every position, caches)."""
        cfg = self.cfg
        G = cfg.group_size
        x = hint(self.embed(tokens), "batch", None, None)
        for i, blk in enumerate(self.layers):
            c = caches[i % G]
            view = type(c)(*(t[i // G] for t in c))
            h = rmsnorm(blk.mixer_ln.scale, x, cfg.norm_eps)
            if blk.kind == "ssm":
                fn = mode.ssm
            else:
                fn = mode.mla if cfg.attn_type == "mla" else mode.gqa
            mix, _ = fn(blk.mixer, cfg, h, view)
            x, _, _ = self._ffn(blk, hint(x + mix, "batch", None, None))
            x = hint(x, "batch", None, None)
        x = rmsnorm(self.final_norm.scale, x, cfg.norm_eps)
        return lm_logits(self.embed, cfg, x), caches

    def decode_step(self, tokens: torch.Tensor, caches: list, index: int
                    ) -> Tuple[torch.Tensor, list]:
        """tokens: (b, 1) at position ``index`` → (logits (b, 1, V) f32,
        caches). Every layer's new rows or state go into ``caches`` in
        place."""
        return self._over_caches(tokens, caches, _Mode(
            lambda p, cfg, h, c: attn.gqa_decode(p, cfg, h, c, index),
            lambda p, cfg, h, c: attn.mla_decode(p, cfg, h, c, index),
            ssm_mod.ssd_decode))

    def decode_step_packed(self, tokens: torch.Tensor, caches: list,
                           indices: torch.Tensor
                           ) -> Tuple[torch.Tensor, list]:
        """tokens: (b, 1); ``indices``: (b,) int on the model's device, row
        r's position → (logits (b, 1, V) f32, caches). Each row's rows or
        state go into ``caches`` in place at its own index."""
        return self._over_caches(tokens, caches, _Mode(
            lambda p, cfg, h, c: attn.gqa_decode_packed(p, cfg, h, c,
                                                        indices),
            lambda p, cfg, h, c: attn.mla_decode_packed(p, cfg, h, c,
                                                        indices),
            ssm_mod.ssd_decode))

    def prefill_chunk(self, tokens: torch.Tensor, caches: list, start: int
                      ) -> Tuple[torch.Tensor, list]:
        """tokens: (b, c) at absolute positions ``start..start+c`` against
        caches whose rows below ``start`` already hold the prefix →
        (logits (b, c, V) f32, caches), the chunk's rows written in place.
        Attention-only stacks: an SSM's recurrent state cannot be entered
        mid-sequence."""
        if has_ssm(self.cfg):
            raise ValueError(
                f"prefill_chunk requires a pure-attention stack; "
                f"{self.cfg.name} has layer_pattern="
                f"{self.cfg.layer_pattern}")
        return self._over_caches(tokens, caches, _Mode(
            lambda p, cfg, h, c: attn.gqa_chunk_append(p, cfg, h, c, start),
            lambda p, cfg, h, c: attn.mla_chunk_append(p, cfg, h, c, start),
            None))

    # -- training ------------------------------------------------------------
    def _embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The token embeddings of ``batch["tokens"]``, the stubs'
        ``frontend_embeds`` over the first positions."""
        return self._embed(batch["tokens"], batch.get("frontend_embeds"))

    def _group_train(self, g: int, x: torch.Tensor, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
        """Group ``g``'s layers over the whole sequence → (x, the group's
        aux loss (f32), its expert counts (e,) int32 or None)."""
        cfg = self.cfg
        G = cfg.group_size
        blocks = self.layers[g * G:(g + 1) * G]
        with _regathered(cfg, blocks):
            return self._group_body(blocks, hint(x, "batch", None, None),
                                    positions)

    def _group_body(self, blocks, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        aux = torch.zeros((), dtype=F32, device=x.device)
        counts = (torch.zeros(cfg.num_experts, dtype=torch.int32,
                              device=x.device) if cfg.num_experts else None)
        for blk in blocks:
            h = rmsnorm(blk.mixer_ln.scale, x, cfg.norm_eps)
            if blk.kind == "ssm":
                mix = ssm_mod.ssd_full(blk.mixer, cfg, h)
            elif cfg.attn_type == "mla":
                mix = attn.mla_full(blk.mixer, cfg, h, positions, train=True)
            else:
                mix = attn.gqa_full(blk.mixer, cfg, h, positions, train=True)
            # the residual stream stays whole on the model dims: a mixer's
            # or FFN's sum over its sharded heads / ffn lanes is reduced
            # where it joins the stream (Megatron's all-reduce)
            x, a, c = self._ffn(blk, hint(x + mix, "batch", None, None))
            x = hint(x, "batch", None, None)
            if a is not None:
                aux = aux + a
                counts = counts + c
        return x, aux, counts

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      remat: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
        """batch: ``tokens`` (b, s) [+ ``frontend_embeds``] → (logits
        (b, s, V) f32, aux loss (f32 scalar), expert counts (e,) int32 or
        None). With ``remat`` each group is recomputed in the backward
        pass instead of keeping its activations."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        aux = torch.zeros((), dtype=F32, device=x.device)
        counts = None
        for g in range(cfg.num_groups):
            if remat:
                x, a, c = checkpoint(self._group_train, g, x, positions,
                                     use_reentrant=False)
            else:
                x, a, c = self._group_train(g, x, positions)
            aux = aux + a
            if c is not None:
                counts = c if counts is None else counts + c
        x = rmsnorm(self.final_norm.scale, x, cfg.norm_eps)
        return lm_logits(self.embed, cfg, x), aux, counts

    def loss_fn(self, batch: Dict[str, torch.Tensor], aux_coef: float = 0.01,
                remat: bool = True) -> Tuple[torch.Tensor, Dict]:
        """Next-token cross entropy over the positions whose label is ≥ 0,
        plus ``aux_coef`` times the MoE aux loss → (loss, metrics ``ce``,
        ``aux``, ``tokens`` [, ``expert_counts``])."""
        logits, aux, counts = self.forward_train(batch, remat)
        labels = batch["labels"].long()
        mask = (labels >= 0).to(F32)
        if isinstance(logits, DTensor):
            nll = _vocab_parallel_nll(logits, labels.clamp(min=0))
        else:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.take_along_dim(logp, labels.clamp(min=0)[..., None],
                                        -1)[..., 0]
        tokens = mask.sum()
        ce = (nll * mask).sum() / torch.clamp(tokens, min=1.0)
        metrics = {"ce": ce, "aux": aux, "tokens": tokens}
        if counts is not None:
            metrics["expert_counts"] = counts
        return ce + aux_coef * aux, metrics


def _axes_slot(cfg: ModelConfig, kind: str, ffn_kind: str) -> Dict:
    p: Dict = {"mixer_ln": axes_rmsnorm()}
    if kind == "ssm":
        p["mixer"] = ssm_mod.axes_ssm()
    else:
        p["mixer"] = (attn.axes_mla() if cfg.attn_type == "mla"
                      else attn.axes_gqa())
    if ffn_kind != "none":
        p["ffn_ln"] = axes_rmsnorm()
        p["ffn"] = (axes_ffn(cfg) if ffn_kind == "dense"
                    else moe_mod.axes_moe(cfg))
    return p


def _flat(tree: Dict, prefix: str = "") -> Dict[str, tuple]:
    out: Dict[str, tuple] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def is_axes_leaf(t) -> bool:
    """A leaf of an axes tree: a plain tuple of logical names (or None)."""
    return (type(t) is tuple
            and all(isinstance(x, (str, type(None))) for x in t))


def param_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Each ``state_dict`` name → the logical names of its dims: the
    reference's ``param_axes`` leaf without the leading ``layers`` entry
    of its group stack (the port keeps one tensor a layer)."""
    out = {f"embed.{k}": v for k, v in _flat(axes_embed(cfg)).items()}
    for i in range(cfg.num_layers):
        slot = i % cfg.group_size
        out.update(_flat(_axes_slot(cfg, cfg.layer_pattern[slot],
                                    cfg.ffn_pattern[slot]), f"layers.{i}."))
    out.update({f"final_norm.{k}": v
                for k, v in _flat(axes_rmsnorm()).items()})
    return out


def cache_axes(cfg: ModelConfig) -> list:
    """The logical names of every cache dim, one tuple per slot, with the
    leading ``layers`` (group stack) entry the caches keep."""
    out = []
    for kind in cfg.layer_pattern:
        if kind == "ssm":
            c = ssm_mod.ssm_cache_axes()
        elif cfg.attn_type == "mla":
            c = attn.mla_cache_axes()
        else:
            c = attn.kv_cache_axes()
        out.append(type(c)(*(("layers",) + t for t in c)))
    return out


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The ``state_dict``'s shapes and dtypes as ``meta`` tensors (no
    allocation)."""
    return dict(Model(cfg, device="meta").state_dict())


def abstract_caches(cfg: ModelConfig, batch: int, s_max: int, dtype
                    ) -> list:
    """:func:`init_caches`' shapes and dtypes as ``meta`` tensors."""
    return init_caches(cfg, batch, s_max, dtype, device="meta")


@contextlib.contextmanager
def _regathered(cfg: ModelConfig, blocks):
    """The group's per-layer parameter re-gather point: under hints with
    ``param_rules`` each block's parameters are swapped for their
    re-placed copies (autograd flows through them to the originals) for
    the body's duration; otherwise nothing happens."""
    ctx = active()
    if ctx is None or ctx.param_rules is None:
        yield
        return
    saved = []
    try:
        for blk in blocks:
            axes = _flat(_axes_slot(cfg, blk.kind, blk.ffn_kind))
            params = dict(blk.named_parameters())
            for name, t in param_hint_tree(params, axes).items():
                path, _, leaf = name.rpartition(".")
                sub = blk.get_submodule(path)
                saved.append((sub, leaf, sub._parameters[leaf]))
                sub._parameters[leaf] = t
        yield
    finally:
        for sub, leaf, p in reversed(saved):
            sub._parameters[leaf] = p


def _vocab_parallel_nll(logits, labels) -> torch.Tensor:
    """``-log_softmax(logits)[label]`` for DTensor logits, each rank on
    its vocab lanes (Megatron's vocab-parallel cross entropy): the
    row max and the exp-sum are reduced over the lanes' mesh dims, the
    label's logit comes from the rank that holds it. DTensor's own
    ``log_softmax`` / ``take_along_dim`` would gather the whole vocab of
    every row."""
    mesh = logits.device_mesh
    v = logits.placements
    lp = tuple(Shard(0) if pl == Shard(logits.ndim - 1) else Replicate()
               for pl in v)
    rows = tuple(pl if isinstance(pl, Shard) and pl.dim < logits.ndim - 1
                 else Replicate() for pl in v)
    lanes = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.device), mesh, lp)
    red = [Partial("max") if pl == Shard(logits.ndim - 1) else r
           for pl, r in zip(v, rows)]
    m = run_local(lambda x: x.detach().amax(-1, keepdim=True), mesh, red,
                  [v], logits).redistribute(mesh, rows)
    red = tuple(Partial() if pl == Shard(logits.ndim - 1) else r
                for pl, r in zip(v, rows))

    def local(x, mx, lab, lane):
        z = x - mx
        hit = lab[..., None] == lane
        return (torch.exp(z).sum(-1, keepdim=True),
                torch.where(hit, z, 0.0).sum(-1))

    sumexp, picked = run_local(local, mesh, (red, red), [v, rows, rows, lp],
                               logits, m, labels, lanes)
    rows2 = rows
    return (torch.log(sumexp.redistribute(mesh, rows2))[..., 0]
            - picked.redistribute(mesh, rows2))


def zero_frontend_embeds(cfg: ModelConfig, model: Model
                         ) -> Optional[torch.Tensor]:
    """Zero stub embeddings (1, num_patches, d) on the model's device for
    a model with a modality frontend, else None: what the reference's
    serving paths pass."""
    if cfg.frontend == "none":
        return None
    return torch.zeros((1, cfg.num_patches, cfg.d_model), dtype=model.dtype,
                       device=model.device)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype,
                device="cuda") -> list:
    """Zero caches, one tuple per slot, each tensor ``(num_groups, batch,
    ...)``: K/V ``(…, s_max, kv, hd)``, MLA latent / roped key
    ``(…, s_max, kv_lora | rope)``, SSM conv tail ``(…, conv_width - 1,
    d_inner + 2·d_state)`` and state ``(…, heads, headdim, d_state)`` in
    f32."""
    _check_supported(cfg)
    dev = resolve_device(device)
    n = cfg.num_groups

    def zeros(*shape, dt=dtype):
        return torch.zeros((n, batch) + shape, dtype=dt, device=dev)

    caches = []
    for kind in cfg.layer_pattern:
        if kind == "ssm":
            caches.append(ssm_mod.SSMCache(
                zeros(cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state),
                zeros(cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                      dt=torch.float32)))
        elif cfg.attn_type == "mla":
            caches.append(attn.MLACache(
                zeros(s_max, cfg.kv_lora_rank), zeros(s_max, cfg.qk_rope_dim)))
        else:
            kv = (s_max, cfg.num_kv_heads, cfg.head_dim)
            caches.append(attn.KVCache(zeros(*kv), zeros(*kv)))
    return caches


def pad_caches(cfg: ModelConfig, caches: list, new_len: int) -> list:
    """Copies of ``caches`` with the attention caches' sequence axis grown
    to ``new_len`` (never shrunk; zero rows appended); SSM caches are
    copied as they are. Always fresh storage, even when nothing grows:
    decode writes into what this returns."""
    out = []
    for kind, c in zip(cfg.layer_pattern, caches):
        if kind == "attn":
            def grow(x):
                shape = list(x.shape)
                shape[2] = max(new_len, x.shape[2])
                y = x.new_zeros(shape)
                y[:, :, :x.shape[2]] = x
                return y
            c = type(c)(*(grow(x) for x in c))
        else:
            c = type(c)(*(x.clone() for x in c))
        out.append(c)
    return out
