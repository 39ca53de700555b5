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
kernel's wide instance, which streams d through shared memory in chunks
and splits o's columns across CTAs in slices of :data:`O_SLICE`
(recomputing the scores once a slice). Every instance takes any ``b * h``
up to 2**31 - 1 (the grid's x) and any ``s`` and ``dv``: the query tiles
of 64 rows and o's slices share its y and z, past 65,535 of either
folded over both (:func:`fits_grid`), heaviest tiles launched first.

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

import torch

from . import ref

#: the kernels, by the names their launches are counted under
WGMMA = "flash_attention_wgmma"
WGMMA_F16 = "flash_attention_wgmma_f16"
TF32X3 = "flash_attention_tf32x3"
#: the kernels, by their C entry points
ENTRIES = {WGMMA: "fa_forward_wgmma", WGMMA_F16: "fa_forward_wgmma_f16",
           TF32X3: "fa_forward_tf32x3"}
#: the kernel of each dtype
BY_DTYPE = {torch.bfloat16: WGMMA, torch.float16: WGMMA_F16,
            torch.float32: TF32X3}
#: CUDA launches of each kernel (plain ints; reset by assigning 0)
LAUNCHES = {name: 0 for name in ENTRIES}
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
#: columns of o one CTA of a wide instance computes (dv > 256 is split)
O_SLICE = 256
#: query rows of one CTA (both kernels)
BQ = 64
#: the grid's limit on its first axis (b * h) and on each of the others
GRID_X, GRID_YZ = 2 ** 31 - 1, 65535


def fits_grid(b: int, s: int, h: int, dv: int) -> bool:
    """Whether the kernels' grid holds a call: ``b * h`` CTAs along x, and
    the (query tile, o slice) pairs along y then z, within 65,535 each
    (the C entry points' ``fits_grid``)."""
    pairs = -(-s // BQ) * -(-dv // O_SLICE)
    return b * h <= GRID_X and -(-pairs // GRID_YZ) <= GRID_YZ


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
    if tma_loads(q.dtype, d, dv) and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
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
        err = getattr(lib, ENTRIES[name])(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError "
                               f"{err})")
        LAUNCHES[name] += 1
    return o


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
