"""Wrappers of the flash-attention CUDA kernels (``csrc/flash_attn.cu``).

Two kernels compute the same function; :func:`kernel_for` picks one from
the dtype and the head widths alone:

* ``flash_attention_wgmma``: bf16 with ``d`` and ``dv`` multiples of 8
  (TMA needs 16-byte strides), on the tensor cores with TMA loads (the
  serve prefill);
* ``flash_attention_simt``: f32 (whose 2e-5 tolerance rules out TF32) and
  bf16 heads of other widths, on the CUDA cores.

:func:`flash_attention_fwd` checks dtype, shapes, contiguity and device,
then:

* for tensors on the CPU, runs the kernels' plain version
  (:func:`.ref.sdpa_ref`; the CPU tests' path);
* for CUDA tensors, launches the chosen kernel on the current stream, or
  raises. Nothing falls back to the other kernel or to the plain version.

``LAUNCHES`` counts each kernel's CUDA launches; only a launch adds to it.
"""
from __future__ import annotations

import torch

from . import ref

#: the two kernels, by the names their launches are counted under
WGMMA = "flash_attention_wgmma"
SIMT = "flash_attention_simt"
#: CUDA launches of each kernel (plain ints; reset by assigning 0)
LAUNCHES = {WGMMA: 0, SIMT: 0}

DTYPES = (torch.float32, torch.bfloat16)
#: the widest q/k (d) and v (dv) head the kernel takes
MAX_HEAD_DIM = 256


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (b, s, heads, dim), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
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
        if not (0 < n <= MAX_HEAD_DIM and n % 4 == 0):
            raise ValueError(f"{name}={n} must be a multiple of 4 in "
                             f"[4, {MAX_HEAD_DIM}]")
    if b * h > 65535:
        raise ValueError(f"b*h={b * h} exceeds the grid's 65535 rows")


def kernel_for(dtype, d: int, dv: int) -> str:
    """The kernel that takes q/k of width ``d`` and v of width ``dv`` in
    ``dtype`` (widths the wrapper accepts): fixed by dtype and shape,
    never by a failure."""
    if dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0:
        return WGMMA
    return SIMT


def _lib():
    from .build import load
    return load()


def launch(q, k, v, causal: bool, name: str):
    """Launch kernel ``name`` on checked CUDA tensors; returns o. The
    wrapper's own path is :func:`flash_attention_fwd`; ``check.py`` also
    times the CUDA-core kernel at bf16 shapes through here."""
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if name == WGMMA:
        if kernel_for(q.dtype, d, dv) != WGMMA or any(
                t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError(f"{WGMMA} takes 16-byte aligned bf16 heads of "
                             f"widths that are multiples of 8, got "
                             f"{q.dtype} d={d} dv={dv}")
        if s > 65535 * 64:
            raise ValueError(f"s={s} exceeds the grid's 65535 query tiles")
    dev = q.device
    o = torch.empty((b, s, h, dv), dtype=v.dtype, device=dev)
    if o.numel():
        lib = _lib()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
                h, kvh, d, dv, 1.0 / (d ** 0.5), int(bool(causal)))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == WGMMA:
            err = lib.fa_forward_wgmma(*args, stream)
        else:
            err = lib.fa_forward(*args, int(q.dtype == torch.bfloat16),
                                 stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError "
                               f"{err})")
        LAUNCHES[name] += 1
    return o


def flash_attention_fwd(q, k, v, causal: bool = True):
    """q: (b, s, h, d); k/v: (b, s, kvh, d/dv) → o: (b, s, h, dv) in
    ``v.dtype``. Query head ``hq`` reads KV head ``hq // (h // kvh)``."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return ref.sdpa_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return launch(q, k, v, causal,
                  kernel_for(q.dtype, q.shape[3], v.shape[3]))
