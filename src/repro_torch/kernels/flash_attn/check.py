"""Hold the flash-attention kernel against its plain version on the same
inputs.

Used by ``chip_smoke.py`` at llama3.2-3b's attention shapes and by the GPU
tests at smaller ones. Inputs are N(0, 1) draws from a seed on the target
device. :func:`check_flash_attention` runs the wrapper (the CUDA kernel
for CUDA tensors) and the plain version, and returns the largest absolute
difference, whether it is within the stated tolerance, the median times
of the kernel, the plain version and one library call computing the same
function (``scaled_dot_product_attention``, timed only: the port never
calls it), and the least time the card could take.

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

from ..flash_hash.check import H100_BYTES_PER_S, time_ms
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


def make_inputs(b, s, h, kvh, d, dv, dtype, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda shape: torch.randn(shape, generator=gen, device=device,
                                     dtype=torch.float32).to(dtype)
    return draw((b, s, h, d)), draw((b, s, kvh, d)), draw((b, s, kvh, dv))


def library_call(q, k, v, causal: bool):
    """``scaled_dot_product_attention`` on (b, h, s, d) copies: the same
    function as the kernel (the yardstick, never used by the port)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def check_flash_attention(b: int, s: int, h: int, kvh: int, d: int, dv: int,
                          dtype, causal: bool, seed: int, device,
                          reps: int = 10) -> Dict:
    """The kernel against the plain version on one seeded case."""
    q, k, v = make_inputs(b, s, h, kvh, d, dv, dtype, seed, device)
    before = dict(K.LAUNCHES)    # comparison launches are not the path's
    got = K.flash_attention_fwd(q, k, v, causal=causal)
    want = ref.sdpa_ref(q, k, v, causal=causal)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    diff = (got.float() - want.float()).abs()
    tol = TOLERANCE[dtype]
    within = bool((diff <= tol + tol * want.float().abs()).all())
    out = {"shape": [b, s, h, kvh, d, dv], "dtype": str(dtype).split(".")[-1],
           "causal": causal, "max_abs_err": float(diff.max()),
           "tolerance": tol, "within_tolerance": within,
           "finite": bool(torch.isfinite(got.float()).all())}
    out["ms"] = time_ms(lambda: K.flash_attention_fwd(q, k, v, causal),
                        reps, device=device)
    K.LAUNCHES.update(before)
    out["plain_ms"] = time_ms(lambda: ref.sdpa_ref(q, k, v, causal), reps,
                              device=device)
    out["library_ms"] = (time_ms(library_call(q, k, v, causal), reps,
                                 device=device)
                         if device.type == "cuda" else None)
    out.update(attention_bound(b, s, h, kvh, d, dv, dtype, causal))
    return out
