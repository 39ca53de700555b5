"""Hold the flash-attention kernels against their plain version on the
same inputs.

Used by ``chip_smoke.py`` at llama3.2-3b's attention shapes and by the GPU
tests at smaller ones. Inputs are N(0, 1) draws from a seed on the target
device; ``qk_scale`` multiplies q and k, so the scores grow by its square
(which stresses the online rescale and the -1e30 masking) while v and the
output keep their size. :func:`check_flash_attention` runs the wrapper
(for CUDA tensors, the kernel :func:`.kernel.kernel_for` picks) and the
plain version, and returns the largest absolute difference, whether it
is within the stated tolerance, the least time the card could take, and
CUDA-event medians timed in turns within one call: the kernel, the
CUDA-core kernel at the same shape where the tensor-core kernel took the
call (the "before"; its error is held too), one library call computing
the same function (``scaled_dot_product_attention``, timed only: the
port never calls it) and the plain version; and the device times of the
kernel, the CUDA-core kernel and the library call with no Python between
launches (``device_ms``, ``simt_device_ms``, ``library_device_ms``:
graph replays, :func:`..flash_hash.check.device_ms`).

That least time (``bound_ms``) is the larger of two: the bytes of q, k,
v and o (each read or written once) over the card's memory rate, and the
FLOPs of the two products over the pairs the mask keeps (2 (d + dv) per
(query, key, head)) over the card's dense peak for the type: the tensor
cores' bf16 rate for bf16, the f32 rate outside the tensor cores for f32
(TF32 would not give the reference's precision).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..flash_hash.check import H100_BYTES_PER_S, device_ms, in_turns, time_ms
from . import kernel as K
from . import ref

#: published dense peaks of an H100 SXM (NVIDIA's data sheet), op/s
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: the tolerances of the reference's kernel tests (tests/test_flash_attn.py)
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def attention_bound(b: int, s: int, h: int, kvh: int, d: int, dv: int,
                    dtype, causal: bool) -> Dict:
    """Least time of one forward: bytes of q, k, v, o at the memory rate
    against FLOPs of the kept pairs at the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    n_bytes = item * b * s * (h * d + kvh * d + kvh * dv + h * dv)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * b * h * (d + dv) * pairs
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_flops = flops / H100_PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_flops), "bound_bytes": n_bytes,
            "bound_flops": flops, "peak_flops_per_s": H100_PEAK_FLOPS[dtype],
            "peak_bytes_per_s": H100_BYTES_PER_S,
            "bound_by": "bytes" if by_bytes >= by_flops else "operations"}


def make_inputs(b, s, h, kvh, d, dv, dtype, seed: int, device,
                qk_scale: float = 1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda shape, x=1.0: (torch.randn(
        shape, generator=gen, device=device, dtype=torch.float32) * x
    ).to(dtype)
    return (draw((b, s, h, d), qk_scale), draw((b, s, kvh, d), qk_scale),
            draw((b, s, kvh, dv)))


def library_call(q, k, v, causal: bool):
    """``scaled_dot_product_attention`` on (b, h, s, d) copies: the same
    function as the kernel (the yardstick, never used by the port)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def _error(got, want, tol) -> Dict:
    diff = (got.float() - want.float()).abs()
    return {"max_abs_err": float(diff.max()),
            "within_tolerance": bool(
                (diff <= tol + tol * want.float().abs()).all()),
            "finite": bool(torch.isfinite(got.float()).all())}


def check_flash_attention(b: int, s: int, h: int, kvh: int, d: int, dv: int,
                          dtype, causal: bool, seed: int, device,
                          reps: int = 10, qk_scale: float = 1.0) -> Dict:
    """The kernel against the plain version on one seeded case."""
    q, k, v = make_inputs(b, s, h, kvh, d, dv, dtype, seed, device,
                          qk_scale)
    name = K.kernel_for(dtype, d, dv)
    tol = TOLERANCE[dtype]
    before = dict(K.LAUNCHES)    # comparison launches are not the path's
    got = K.flash_attention_fwd(q, k, v, causal=causal)
    want = ref.sdpa_ref(q, k, v, causal=causal)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    out = {"shape": [b, s, h, kvh, d, dv], "dtype": str(dtype).split(".")[-1],
           "causal": causal, "qk_scale": qk_scale,
           "kernel": name if cuda else "plain", "tolerance": tol,
           **_error(got, want, tol)}
    if cuda:
        fns = {"ms": lambda _: K.launch(q, k, v, causal, name)}
        if name != K.SIMT:
            simt = K.launch(q, k, v, causal, K.SIMT)
            torch.cuda.synchronize(device)
            err = _error(simt, want, tol)
            out.update({f"simt_{key}": val for key, val in err.items()})
            fns["simt_ms"] = lambda _: K.launch(q, k, v, causal, K.SIMT)
        library = library_call(q, k, v, causal)
        fns["library_ms"] = lambda _: library()
        on_device = {key[:-2] + "device_ms": fn for key, fn in fns.items()}
        fns["plain_ms"] = lambda _: ref.sdpa_ref(q, k, v, causal)
        out.update(in_turns(fns, reps, device))
        out.update(device_ms(on_device, reps, device))
    else:
        out["ms"] = time_ms(lambda: K.flash_attention_fwd(q, k, v, causal),
                            reps)
        out["plain_ms"] = time_ms(lambda: ref.sdpa_ref(q, k, v, causal),
                                  reps)
        out["library_ms"] = None
    K.LAUNCHES.update(before)
    out.update(attention_bound(b, s, h, kvh, d, dv, dtype, causal))
    for key in ("ms", "simt_ms", "library_ms", "plain_ms", "device_ms",
                "simt_device_ms", "library_device_ms"):
        if out.get(key):
            out[key[:-2] + "bound_share"] = out["bound_ms"] / out[key]
    return out
