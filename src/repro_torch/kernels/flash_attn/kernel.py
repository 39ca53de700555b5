"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attn.cu``).

:func:`flash_attention_fwd` checks dtype, shapes, contiguity and device,
then:

* for tensors on the CPU, runs the kernel's plain version
  (:func:`.ref.sdpa_ref`; the CPU tests' path);
* for CUDA tensors, launches the CUDA kernel on the current stream, or
  raises. There is no fallback from the card to the plain version.

``LAUNCHES`` counts CUDA launches; only a launch adds to it.
"""
from __future__ import annotations

import torch

from . import ref

#: CUDA launches (a plain int; reset by assigning 0)
LAUNCHES = {"flash_attention": 0}

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


def _lib():
    from .build import load
    return load()


def flash_attention_fwd(q, k, v, causal: bool = True):
    """q: (b, s, h, d); k/v: (b, s, kvh, d/dv) → o: (b, s, h, dv) in
    ``v.dtype``. Query head ``hq`` reads KV head ``hq // (h // kvh)``."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return ref.sdpa_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    o = torch.empty((b, s, h, dv), dtype=v.dtype, device=dev)
    if o.numel():
        err = _lib().fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            kvh, d, dv, 1.0 / (d ** 0.5), int(bool(causal)),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention: CUDA launch failed "
                               f"(cudaError {err})")
        LAUNCHES["flash_attention"] += 1
    return o
