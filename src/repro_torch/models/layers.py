"""Shared layer primitives: norms, RoPE, embeddings, dense FFN variants.

Weights live in ``nn.Module``s whose parameter names and shapes are the
reference's pytree leaves (``scale``, ``tokens``, ``w_gate``, ...), so a
reference pytree maps onto a ``state_dict`` by name (``convert.py``).
Each ``forward`` computes what the reference's function of the same name
does, in the same precision steps: norms, RoPE and the softmax in f32;
a matrix product whose result the reference keeps in f32 (the FFN's
gate / up / in, the logits) gives an f32 result from operands in the
activations' type (:func:`matmul_f32`), one it casts at once runs in the
activations' type, which rounds the f32 sum once as the cast does; a
row-parallel product's partial sums are reduced in f32 and cast after
(:func:`matmul_rows`); in a sharded step each weight's gradient is
summed over the ranks in the type of the reference's transpose (f32 for
an f32-result product and a weight it widens) and cast once. Every
module's ``axes_*`` sibling names the
logical axis of each parameter dim (the reference's ``axes_*``), which
``launch/sharding.py`` maps onto a device mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from .config import ModelConfig
from .sharding_hints import (column_parallel, grad_in_f32, row_parallel,
                             run_local, wants_f32_grad, weight_in_f32)

F32 = torch.float32
BF16 = torch.bfloat16
NEG = -1e30


#: the config ``dtype`` strings a model runs in: the floating types the
#: reference's model runs (``jnp.dtype(cfg.dtype)``) and the port's
#: kernels take
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a config's ``dtype`` string."""
    dt = DTYPES.get(name)
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


class _BF16GradBoundary(torch.autograd.Function):
    """The identity, whose backward hands on the gradient in bf16: the
    reference's ``bf16_grad_boundary`` (``opt_bf16_grads``), placed where
    a residual-stream gradient crosses a reduction, so that reduction
    moves half the bytes."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(BF16)


def bf16_grad_boundary(x: torch.Tensor) -> torch.Tensor:
    return _BF16GradBoundary.apply(x)


def _mm_f32(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """``a @ b`` (2-D, one type) with an f32 result (into ``out`` if
    given). On a card (and on the dry-run's fake tensors, which stand for
    the card's) ``mm.dtype``: the f32 accumulator is the result, and no
    operand is widened in memory. The CPU has no kernel for it; there the
    operands are widened, which forms the same exact products of their
    values."""
    if a.is_cuda or a.device.type == "meta" or is_fake(a):
        return torch.mm(a, b, out_dtype=F32, out=out)
    return torch.mm(a.to(F32), b.to(F32), out=out)


class _F32Product(torch.autograd.Function):
    """The gradient of ``x @ w`` (x (n, k), w (k, m)) with an f32 result
    from operands in w's type (x is cast to it: an f32 x holds w-type
    values, see :func:`sharding_hints.grad_in_f32`); ``mm.dtype`` has no
    derivative. x's gradient is again an f32-result product (the
    reference's transpose of an f32-result einsum), handed on in x's
    type; w's a product in w's type (the f32 sum rounded once), or, with
    ``grad_to`` (a sharded step's weight: ``sharding_hints._run_product``),
    its f32 result summed over the ranks before the one rounding: by
    ``grad_to`` itself if it is a function (autograd then casts the sum
    to w's type), else by the carrier it is, which takes it. The forward
    only saves x and w and allocates the result, which
    :func:`_product_f32` fills after: the inputs are packed before the
    product runs, as aten's own products pack theirs, so the recompute
    of a checkpointed group stops before a product at its end."""

    @staticmethod
    def forward(ctx, x, w, grad_to=None):
        ctx.save_for_backward(x, w)
        ctx.sum = grad_to if callable(grad_to) else None
        return x.new_empty((x.shape[0], w.shape[1]), dtype=F32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        need = ctx.needs_input_grad
        gx = _mm_f32(g, w.t()) if need[0] else None
        xt = _as(x, w.dtype).t()
        gw = gc = None
        if need[1] and ctx.sum is not None:
            gw = ctx.sum(_mm_f32(xt, g))
        elif need[1]:
            gw = torch.mm(xt, g)
        if need[2]:
            gc = _mm_f32(xt, g)
        return gx, gw, gc


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t.to(dtype)``, without the op when t has it already (a decode
    step's ops are its host cost)."""
    return t if t.dtype == dtype else t.to(dtype)


def _product_f32(x: torch.Tensor, w: torch.Tensor,
                 grad_to=None) -> torch.Tensor:
    """x (..., k) @ w (k, m) → (..., m) in f32 (:func:`matmul_f32`); w's
    gradient as ``grad_to`` says (:class:`_F32Product`)."""
    if x.dtype == F32 and w.dtype == F32:
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or grad_to is not None):
        y = _F32Product.apply(x2, w, grad_to)
        with torch.no_grad():
            _mm_f32(_as(x2, w.dtype), w, out=y)
    else:
        y = _mm_f32(_as(x2, w.dtype), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 result (the reference's
    ``preferred_element_type=jnp.float32``), x's last axis contracted with
    w's first: the exact products of the operands summed in f32, with no
    f32 copy of w on a card. f32 operands take the plain product. With a
    DTensor ``w``, column-parallel (:func:`matmul_heads`)."""
    return matmul_heads(x, w, f32=True)


def matmul_heads(x: torch.Tensor, w: torch.Tensor,
                 f32: bool = False) -> torch.Tensor:
    """``einsum("...d,d...->...", x, w)``: contract x's last axis with w's
    first, keeping w's other axes; in x's type, or in f32 with ``f32``.
    With a DTensor ``w``, column-parallel on each rank's shard
    (``sharding_hints.column_parallel``); an f32 ``x`` over a lower-type
    ``w`` (:func:`sharding_hints.grad_in_f32`) is taken as w's type and
    gets its gradient as an f32-result product. A DTensor ``w`` whose
    gradient this pass computes takes it as the reference does, summed
    over the ranks in f32 and cast once (``sharding_hints._run_product``;
    the product then runs as an f32 result, and a result in x's type is
    that f32 sum rounded once, as a product in that type gives it)."""
    if not isinstance(w, DTensor):
        return _matmul_heads(x, w, f32)
    if wants_f32_grad(w):
        cast = None if f32 else w.dtype
        return column_parallel(
            lambda a, b, c: _matmul_heads(a, b, True, cast, c), x, w,
            f32_grad=True)
    if f32 or x.dtype == w.dtype:
        return column_parallel(lambda a, b: _matmul_heads(a, b, f32), x, w)
    # x widened by grad_in_f32: the f32-result product, cast at once
    return column_parallel(lambda a, b: _matmul_heads(a, b, True, b.dtype),
                           x, w)


def matmul_rows(x: torch.Tensor, w: torch.Tensor,
                reduce_f32: bool = True) -> torch.Tensor:
    """Contract x's trailing axes with all of w's but its last
    (``x @ w`` for a 2-D w, ``einsum("bshk,hkd->bsd")`` for a 3-D one),
    in x's type. With a DTensor ``w``, row-parallel on each rank's shard
    of the contracted axes (``sharding_hints.row_parallel``): with
    ``reduce_f32`` each rank's partial sum is an f32 result, the partials
    are summed in f32 and the sum is cast to x's type (the reference's
    f32-result einsum, cast after); without it the partials are taken and
    summed in x's type (its ``preferred_element_type=None``); w's
    gradient in the same type as the sum (:func:`matmul_heads`)."""
    if not isinstance(w, DTensor):
        return _matmul_rows(x, w)
    if not reduce_f32 or x.dtype == F32:
        return row_parallel(_matmul_rows, x, w)
    if wants_f32_grad(w):
        return row_parallel(lambda a, b, c: _matmul_rows(a, b, True, c),
                            x, w, reduce_to=x.dtype, f32_grad=True)
    return row_parallel(lambda a, b: _matmul_rows(a, b, True), x, w,
                        reduce_to=x.dtype)


def _matmul_heads(x: torch.Tensor, w: torch.Tensor, f32: bool = False,
                  cast=None, grad_to=None) -> torch.Tensor:
    if f32:
        if w.ndim == 2:           # no reshape: as few ops as torch.matmul
            y = _product_f32(x, w, grad_to)
        else:
            w2 = w.reshape(w.shape[0], -1)
            y = _product_f32(x, w2, _like(grad_to, w2)).reshape(
                *x.shape[:-1], *w.shape[1:])
        return y if cast is None else y.to(cast)
    d = w.shape[0]
    return torch.matmul(x, w.reshape(d, -1)).reshape(*x.shape[:-1],
                                                     *w.shape[1:])


def _matmul_rows(x: torch.Tensor, w: torch.Tensor,
                 f32: bool = False, grad_to=None) -> torch.Tensor:
    if w.ndim > 2:        # a 2-D w: the unsharded ops stay as they were
        x = x.reshape(*x.shape[:x.ndim - (w.ndim - 1)], -1)
        w = w.reshape(-1, w.shape[-1])
        grad_to = _like(grad_to, w)
    if f32 or grad_to is not None:
        return _product_f32(x, w, grad_to)
    return torch.matmul(x, w)


def _like(grad_to, w: torch.Tensor):
    """A weight's carrier reshaped as the weight is for its 2-D product
    (a 0-stride carrier reshapes as a view); a function as it is."""
    if isinstance(grad_to, torch.Tensor):
        return grad_to.reshape(w.shape)
    return grad_to


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight_in_f32(scale)).to(dt)


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

    The product's result is f32 (:func:`matmul_f32`), as the reference's:
    the logits carry no rounding to x's type. A vocab-split head runs
    column-parallel on each rank's lanes (no reduction); x's gradient,
    summed over those ranks, is summed in f32."""
    w = embed.tokens.t() if cfg.tie_embeddings else embed.head
    logits = matmul_f32(grad_in_f32(x), w)
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
    """The gate / up / in products give f32 results into the activation,
    as the reference's; ``w_down`` is cast after its sum, which
    ``opt_bf16_grads`` takes in x's type (the reference's ``pet``). With
    DTensor weights, Megatron's column- then row-parallel pair
    (:func:`matmul_heads`, :func:`matmul_rows`) on each rank's ffn lanes:
    a partial sum over the mesh dims that split them (DTensor's own
    propagation may gather the whole weight), reduced in f32 unless
    ``opt_bf16_grads``; x's gradient is summed over those dims in f32
    unless ``opt_bf16_grads``, which takes it in bf16."""
    dt = x.dtype
    if cfg.opt_bf16_grads:
        x = bf16_grad_boundary(x)
    else:
        x = grad_in_f32(x)
    if cfg.ffn_act == "swiglu":
        g = matmul_f32(x, p.w_gate)
        u = matmul_f32(x, p.w_up)
        h = (F.silu(g) * u).to(dt)
    else:
        h = matmul_f32(x, p.w_in)
        if cfg.ffn_act == "gelu":
            h = F.gelu(h, approximate="tanh").to(dt)
        elif cfg.ffn_act == "squared_relu":   # Nemotron-4 (Primer)
            h = torch.square(F.relu(h)).to(dt)
        else:
            raise ValueError(cfg.ffn_act)
    return matmul_rows(h, p.w_down,
                       reduce_f32=not cfg.opt_bf16_grads).to(dt)
