"""Wrappers of the flash-attention CUDA kernels (``csrc/flash_attn.cu``).

Two kernels compute the same function, both on the tensor cores, and
both take every head width ``d`` and ``dv`` from 1 up, each call in one
launch. The first is instanced for each 2-byte type, so three names are
counted, and :func:`kernel_for` picks one by the dtype alone:

* ``flash_attention_wgmma``: bf16 (the serve prefill);
* ``flash_attention_wgmma_f16``: f16, the same kernel with f16 MMAs and
  P and the output rounded to f16 (a float16 model's prefill);
* ``flash_attention_tf32x3``: f32, in three TF32 passes (the f32
  tolerance of 2e-5 rules out one TF32 pass, not three).

Each loads its tiles by TMA where a head's row is a multiple of 16 bytes
(:func:`tma_loads`: bf16 and f16 widths multiples of 8, f32 of 4; a
tensor map needs 16-byte strides), and otherwise with its producer
warp's own loads into the same shared-memory layout, the columns past
the width and the rows past ``s`` zero-filled as TMA fills them; the C
entry point picks the route. Heads up to 256 columns (d and dv) take
instances that hold Q and a whole O row; a wider head takes each
kernel's wide instance: two warpgroups on the same query rows, each
computing the scores over half of d's columns (the two partial sums
exchanged and added) and holding half of the CTA's columns of o, d
streamed through shared memory in chunks, so the scores are computed once
for up to 512 columns of o; o is split across CTAs only past that, or in
slices of 256 where those CTAs still fit in one wave of the card
(:func:`slice_cols`; :func:`wide_plan` says how a shape is taken). The f32
wide instance first splits q, k and v into their TF32 hi and lo parts
(and V^T) in a pre-pass of the same call, into scratch this wrapper
allocates (:func:`split_floats`), then loads every operand by TMA. Every
instance takes any ``b * h`` up to 2**31 - 1 (the grid's x) and any
``s`` and ``dv``: the query tiles of 64 rows and o's slices share its y
and z, past 65,535 of either folded over both (:func:`fits_grid`),
heaviest tiles launched first.

:func:`flash_attention_fwd` checks dtype, shapes, contiguity and device,
refuses inputs that need a gradient (neither the kernels nor the
reference's Pallas kernel have a backward; training attends through
``models.attention._sdpa``), then:

* for tensors on the CPU, runs the kernels' plain version
  (:func:`.ref.sdpa_ref`; the CPU tests' path);
* for CUDA tensors, launches the chosen kernel on the current stream, or
  raises. Nothing falls back to another kernel or to the plain version.

Every kernel takes a sliding window (``window`` > 0, causal only: query i
keeps key j iff ``i - window < j <= i``) and skip the key tiles wholly
before it; ``window=0`` is the unwindowed launch.

``LAUNCHES`` counts each kernel's CUDA launches; only a launch adds to it.
``SPLIT_LAUNCHES`` counts the f32 wide instance's pre-pass the same way
(one with each wide f32 launch, and each :func:`split_launch`).
``NOTE``, when set (``launch/op_analysis.OpCounter``), is told of every
launch (``note(q, k, v, causal, window)``): a ctypes launch is no aten op
a dispatch mode could count.
``STANDIN`` is set while a dense stand-in computes what a launch would
(a dry-run over fake tensors, which no kernel can read): what it
allocates is the score traffic the kernel keeps on chip.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch

from . import ref

#: the kernels, by the names their launches are counted under
WGMMA = "flash_attention_wgmma"
WGMMA_F16 = "flash_attention_wgmma_f16"
TF32X3 = "flash_attention_tf32x3"
#: the kernels, by their C entry points
ENTRIES = {WGMMA: "fa_forward_wgmma", WGMMA_F16: "fa_forward_wgmma_f16",
           TF32X3: "fa_forward_tf32x3"}
#: the f32 wide instance's pre-pass, by the name its launches are counted
#: under, and its C entry point (alone; ``fa_forward_tf32x3`` launches it
#: before every wide f32 call)
TF32X3_SPLIT = "flash_attention_tf32x3_split"
SPLIT_ENTRY = "fa_tf32x3_split"
#: the kernel of each dtype
BY_DTYPE = {torch.bfloat16: WGMMA, torch.float16: WGMMA_F16,
            torch.float32: TF32X3}
#: CUDA launches of each kernel (plain ints; reset by assigning 0)
LAUNCHES = {name: 0 for name in ENTRIES}
#: CUDA launches of the pre-pass (a plain int under its name)
SPLIT_LAUNCHES = {TF32X3_SPLIT: 0}
#: ``note(q, k, v, causal, window)`` called at each launch, or None
NOTE: contextvars.ContextVar = contextvars.ContextVar("flash_attn_note",
                                                      default=None)
#: True while a dense stand-in of the kernel runs
STANDIN: contextvars.ContextVar = contextvars.ContextVar(
    "flash_attn_standin", default=False)


@contextlib.contextmanager
def standing_in():
    """Mark a dense stand-in of a launch (see the module docstring)."""
    token = STANDIN.set(True)
    try:
        yield
    finally:
        STANDIN.reset(token)

DTYPES = tuple(BY_DTYPE)
#: columns of o one CTA of a wide instance computes at most (dv > 512 is
#: split; :func:`slice_cols`), half of them a consumer warpgroup
O_SLICE = 512
WG_COLS = 256
#: an H100's SMs: one wave of one-CTA-an-SM CTAs
SMS = 132
#: heads wider than this (d or dv) take a kernel's wide instance
NARROW_MAX = 256
#: the widest d whose Q the bf16 / f16 wide instance keeps in shared memory
Q_RESIDENT_MAX = 576
#: query rows of one CTA (both kernels)
BQ = 64
#: the grid's limit on its first axis (b * h) and on each of the others
GRID_X, GRID_YZ = 2 ** 31 - 1, 65535


def slice_cols(b: int, s: int, h: int, dv: int) -> int:
    """Columns of o one CTA of a wide instance computes, fixed by the shape
    alone (``flash_attn.cu``'s ``wide::slice_cols``): 512, or 256 where dv
    <= 256 (each consumer warpgroup then holds half of them) or where the
    CTAs of 256 columns still fit in one wave of the card's 132 SMs (a
    query tile then takes more CTAs, each computing the scores again, on
    SMs that would idle)."""
    tiles = b * h * -(-s // BQ)
    if dv <= WG_COLS or tiles * -(-dv // (O_SLICE // 2)) <= SMS:
        return O_SLICE // 2
    return O_SLICE


def fits_grid(b: int, s: int, h: int, dv: int) -> bool:
    """Whether the kernels' grid holds a call: ``b * h`` CTAs along x, and
    the (query tile, o slice) pairs along y then z, within 65,535 each
    (the C entry points' ``fits_grid``)."""
    pairs = -(-s // BQ) * -(-dv // slice_cols(b, s, h, dv))
    return b * h <= GRID_X and -(-pairs // GRID_YZ) <= GRID_YZ


def wide_plan(dtype, b: int, s: int, h: int, d: int, dv: int) -> Dict:
    """How a call of this shape runs, fixed by the dtype and the shape
    alone (the C entry points follow the same rules): ``wide`` (d or dv
    over 256) and the load route (``tma`` / ``warp`` as :func:`tma_loads`;
    the f32 wide instance ``split``: the pre-pass, then TMA); for a wide
    call also o's columns a CTA computes (:func:`slice_cols`) and so the
    CTAs a query tile takes, each computing the scores once, the
    warpgroups of the first CTA that hold o's columns (each computes its
    half of the scores all the same), d's chunks a key tile streams and
    their width, and whether Q stays in shared memory (bf16 / f16 where d
    <= 576)."""
    wide = max(d, dv) > NARROW_MAX
    plan = {"wide": wide,
            "loads": "tma" if tma_loads(dtype, d, dv) else "warp"}
    if not wide:
        return plan
    f32 = dtype == torch.float32
    chunk = 64 if f32 else 4 * 64 if d <= Q_RESIDENT_MAX else 2 * 64
    sw = slice_cols(b, s, h, dv)
    plan.update(slice_cols=sw, ctas_per_query_tile=-(-dv // sw),
                warpgroups_with_columns=1 if dv <= sw // 2 else 2,
                d_chunks=-(-d // chunk), d_chunk=chunk,
                q_resident=not f32 and d <= Q_RESIDENT_MAX)
    if f32:
        plan["loads"] = "split"
    return plan


def split_floats(b: int, s: int, h: int, kvh: int, d: int, dv: int) -> int:
    """Floats of the f32 wide instance's scratch (its pre-pass's output,
    as ``flash_attn.cu``'s ``split_floats``): q's and k's rows as (b, s,
    heads, 2 dp), hi then lo, dp = d rounded up to 32; V^T as (b, kvh, 2,
    dv, s8), s8 = s rounded up to 8."""
    dp, s8 = -(-d // 32) * 32, -(-s // 8) * 8
    return b * s * (h + kvh) * 2 * dp + b * kvh * 2 * dv * s8


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (b, s, heads, dim), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32, bfloat16 or "
                            f"float16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if k.shape != (b, s, kvh, d) or v.shape[:3] != (b, s, kvh):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (b, s, h, d), "
                         f"(b, s, kvh, d), (b, s, kvh, dv)")
    if kvh == 0 or h % kvh:
        raise ValueError(f"h={h} is not a multiple of kvh={kvh}")
    for name, n in (("d", d), ("dv", dv)):
        if n < 1:
            raise ValueError(f"{name}={n}: a head is at least 1 wide")
    if not fits_grid(b, s, h, dv):
        raise ValueError(f"b*h={b * h} past {GRID_X}, or s={s} and dv={dv} "
                         f"past {GRID_YZ}**2 (query tile, o slice) pairs: "
                         f"more than the grid holds")


def kernel_for(dtype, d: int, dv: int) -> str:
    """The kernel that takes q/k of width ``d`` and v of width ``dv`` in
    ``dtype`` (widths the wrapper accepts): fixed by the dtype alone,
    never by a width or a failure."""
    return BY_DTYPE[dtype]


def tma_loads(dtype, d: int, dv: int) -> bool:
    """Whether the kernel loads q, k and v by TMA (rows of 16-byte
    multiples), as its C entry point decides; else by its producer warp."""
    item = 4 if dtype == torch.float32 else 2
    return d * item % 16 == 0 and dv * item % 16 == 0


def _lib():
    from .build import load
    return load()


def launch(q, k, v, causal: bool, name: str, window: int = 0):
    """Launch kernel ``name`` on checked CUDA tensors; returns o. The
    wrapper's own path is :func:`flash_attention_fwd`; ``check.py`` times
    raw launches through here."""
    ref.check_window(causal, window)
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if kernel_for(q.dtype, d, dv) != name:
        raise ValueError(f"{name} does not take {q.dtype} heads")
    split = name == TF32X3 and max(d, dv) > NARROW_MAX
    if (tma_loads(q.dtype, d, dv) and not split
            and any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"{name} loads d={d} dv={dv} by TMA: q, k and v "
                         f"must be 16-byte aligned")
    dev = q.device
    o = torch.empty((b, s, h, dv), dtype=v.dtype, device=dev)
    if o.numel():
        lib = _lib()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
                h, kvh, d, dv, 1.0 / (d ** 0.5), int(bool(causal)),
                int(window))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == TF32X3:   # the wide instance's scratch (else none)
            scratch = torch.empty(split_floats(b, s, h, kvh, d, dv),
                                  dtype=torch.float32,
                                  device=dev) if split else None
            args += ((scratch.data_ptr(), 4 * scratch.numel()) if split
                     else (None, 0))
        err = getattr(lib, ENTRIES[name])(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError "
                               f"{err})")
        LAUNCHES[name] += 1
        if split:
            SPLIT_LAUNCHES[TF32X3_SPLIT] += 1
    return o


def split_launch(q, k, v):
    """The f32 wide instance's pre-pass alone on f32 CUDA tensors (any
    widths): the scratch it writes (:func:`split_floats` floats, laid out
    as :func:`.ref.tf32_split`'s); counted in ``SPLIT_LAUNCHES``."""
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    dev = q.device
    out = torch.empty(split_floats(b, s, h, kvh, d, dv), dtype=torch.float32,
                      device=dev)
    if out.numel():
        err = getattr(_lib(), SPLIT_ENTRY)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, h, kvh, d, dv,
            out.data_ptr(), 4 * out.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{TF32X3_SPLIT}: CUDA launch failed "
                               f"(cudaError {err})")
        SPLIT_LAUNCHES[TF32X3_SPLIT] += 1
    return out


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0):
    """q: (b, s, h, d); k/v: (b, s, kvh, d/dv) → o: (b, s, h, dv) in
    ``v.dtype``. Query head ``hq`` reads KV head ``hq // (h // kvh)``;
    ``window`` > 0 attends each query to its last ``window`` keys.

    Forward only: with grad mode on and any input requiring grad it
    raises rather than hand back an output autograd would treat as a
    constant."""
    _check(q, k, v)
    ref.check_window(causal, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd has no backward: an input requires grad. "
            "The training path (Model.forward_train / loss_fn) attends "
            "through models.attention._sdpa / _sdpa_chunked; run prefill "
            "under torch.no_grad() or torch.inference_mode()")
    dev = q.device
    if dev.type == "cpu":
        return ref.sdpa_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    note = NOTE.get()
    if note is not None:
        note(q, k, v, causal, window)
    return launch(q, k, v, causal,
                  kernel_for(q.dtype, q.shape[3], v.shape[3]), window)
