"""Hold the flash-attention kernels against their plain version on the
same inputs.

Used by ``chip_smoke.py`` at llama3.2-3b's attention shapes and by the GPU
tests at smaller ones. Inputs are N(0, 1) draws from a seed on the target
device; ``qk_scale`` multiplies q and k, so the scores grow by its square
(which stresses the online rescale and the -1e30 masking) while v and the
output keep their size. :func:`check_flash_attention` runs the wrapper
(for CUDA tensors, the kernel :func:`.kernel.kernel_for` picks, by TMA
or by its own loads as :func:`.kernel.tma_loads` says) and the plain
version, and returns the largest absolute difference, whether it is
within the stated tolerance, the least time the card could take, and
CUDA-event medians timed in turns within one call: the kernel, one
library call computing the same function (``scaled_dot_product_attention``,
timed only: the port never calls it) and the plain version; and the
device times of the kernel and the library call with no Python between
launches (``device_ms``, ``library_device_ms``: graph replays,
:func:`..flash_hash.check.device_ms`). With a sliding ``window`` the
kernel and the plain version take it, the library call takes the dense
boolean band mask, and the same kernel's causal launch at the same shape
is timed beside it (``causal_ms``, ``causal_device_ms``). Each result
carries the kernel's plan (:func:`.kernel.wide_plan`) and, where both
device times exist, ``library_ratio`` (the kernel's over the library
call's, in one call); an f32 wide case also times its pre-pass alone
(``split_device_ms`` beside ``split_bound_ms``), which
:func:`check_tf32_split` holds bit for bit to :func:`.ref.tf32_split`.

That least time (``bound_ms``) is the larger of two: the bytes of q, k,
v and o (each read or written once, at the true widths d and dv, never
the padded ones, nor the scores a wide instance recomputes once a slice
of o's columns) over the card's memory rate, and the
FLOPs of the two products over the pairs the mask keeps (2 (d + dv) per
(query, key, head); :func:`kept_pairs`) at the card's dense peak for the
type. For bf16 and f16 that is the tensor cores' dense rate for the
type (the same 989 TFLOP/s). For f32 it is the
faster of two ways to the reference's precision: the CUDA cores' f32
rate, or three TF32 passes on the tensor cores (one TF32 pass would not
hold 2e-5), so 3 x the FLOPs at the TF32 rate; ``bound_peak`` names the
one taken.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..flash_hash.check import H100_BYTES_PER_S, device_ms, in_turns, time_ms
from . import kernel as K
from . import ref

#: published dense peaks of an H100 SXM (NVIDIA's data sheet), op/s
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
                   torch.float32: 67e12}
#: the tensor cores' dense TF32 peak, op/s, and the passes an f32 product
#: takes there at the reference's precision (hi hi + hi lo + lo hi)
H100_TF32_FLOPS = 494.7e12
TF32_PASSES = 3
#: the tolerances of the reference's kernel tests (tests/test_flash_attn.py);
#: f16, which they do not sweep: 4e-3, about 4 f16 ulps at 1.0 (2**-10
#: each) for an output rounded once from f32 sums of P rounded to f16
#: (the reference's Pallas kernel reads 9.8e-4 against its oracle on its
#: GQA 4:1 case), and tighter than bf16's 2e-2 by the 3 bits more that an
#: f16 mantissa keeps
TOLERANCE = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
             torch.float32: 2e-5}


def kept_pairs(s: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the mask keeps over ``s`` positions: all s², the
    causal s (s + 1) / 2, or with a window w the first m = min(w, s) rows'
    m (m + 1) / 2 plus w for each row after."""
    if not causal:
        return s * s
    m = min(window, s) if window else s
    return m * (m + 1) // 2 + (s - m) * window


def attention_bound(b: int, s: int, h: int, kvh: int, d: int, dv: int,
                    dtype, causal: bool, window: int = 0) -> Dict:
    """Least time of one forward: bytes of q, k, v, o at the memory rate
    against FLOPs of the kept pairs at the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    n_bytes = item * b * s * (h * d + kvh * d + kvh * dv + h * dv)
    pairs = kept_pairs(s, causal, window)
    flops = 2 * b * h * (d + dv) * pairs
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    peaks = {f"{'f16' if dtype == torch.float16 else 'bf16'} tensor cores":
             H100_PEAK_FLOPS[dtype]}
    if dtype == torch.float32:
        peaks = {"f32 CUDA cores": H100_PEAK_FLOPS[dtype],
                 "tf32 x3 tensor cores": H100_TF32_FLOPS / TF32_PASSES}
    peak = min(peaks, key=lambda k: flops / peaks[k])
    by_flops = flops / peaks[peak] * 1e3
    return {"bound_ms": max(by_bytes, by_flops), "bound_bytes": n_bytes,
            "bound_pairs": pairs, "bound_flops": flops,
            "peak_flops_per_s": peaks[peak], "bound_peak": peak,
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


def library_call(q, k, v, causal: bool, window: int = 0):
    """``scaled_dot_product_attention`` on (b, h, s, d) copies made before
    the call: the same function as the kernel (the yardstick, never used
    by the port); with a window, under the dense boolean band mask (s, s).
    bf16 and f16 heads up to 256 columns go with ``enable_gqa`` (its flash
    route takes GQA in either type). In f32, and past 256 columns in any
    type, no fused route takes ``enable_gqa`` (the call falls to the math
    route's f32 GEMMs on the CUDA cores, 2.6-4x slower on an H100 in f32),
    so K and V are copied out to every query head and the
    memory-efficient route takes the call where it takes the widths (rows
    a multiple of 8 elements); elsewhere the call runs whatever route
    PyTorch picks: :func:`library_kernels` names it."""
    import torch.nn.functional as F
    gqa = (q.dtype != torch.float32
           and max(q.shape[-1], v.shape[-1]) <= 256)
    if not gqa:
        g = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    pos = torch.arange(q.shape[1], device=q.device)
    band = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - window))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=gqa)


def library_kernels(b: int, s: int, h: int, kvh: int, d: int, dv: int,
                    dtype, causal: bool, seed: int, device,
                    window: int = 0, calls: int = 5) -> Dict[str, float]:
    """The device kernels :func:`library_call` runs on one seeded case, by
    name, with their mean device microseconds a call, from a
    ``torch.profiler`` (CUPTI) trace of ``calls`` calls after a warm-up:
    which route the library takes (its f32 attention, for one). Raises
    without CUDA."""
    import warnings

    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        raise RuntimeError("library_kernels needs a CUDA device")
    q, k, v = make_inputs(b, s, h, kvh, d, dv, dtype, seed, device)
    fn = library_call(q, k, v, causal, window)
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    with warnings.catch_warnings():   # one profiling cycle: nothing dropped
        warnings.simplefilter("ignore", UserWarning)
        events = prof.key_averages()
    out = {}
    for e in events:
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key] = us / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _error(got, want, tol) -> Dict:
    diff = (got.float() - want.float()).abs()
    return {"max_abs_err": float(diff.max()),
            "within_tolerance": bool(
                (diff <= tol + tol * want.float().abs()).all()),
            "finite": bool(torch.isfinite(got.float()).all())}


def check_flash_attention(b: int, s: int, h: int, kvh: int, d: int, dv: int,
                          dtype, causal: bool, seed: int, device,
                          reps: int = 10, qk_scale: float = 1.0,
                          window: int = 0) -> Dict:
    """The kernel against the plain version on one seeded case."""
    q, k, v = make_inputs(b, s, h, kvh, d, dv, dtype, seed, device,
                          qk_scale)
    name = K.kernel_for(dtype, d, dv)
    tol = TOLERANCE[dtype]
    plan = K.wide_plan(dtype, b, s, h, d, dv)
    split = plan["loads"] == "split"
    before = dict(K.LAUNCHES)    # comparison launches are not the path's
    split_before = dict(K.SPLIT_LAUNCHES)
    got = K.flash_attention_fwd(q, k, v, causal=causal, window=window)
    launched = {key: K.LAUNCHES[key] - before[key] for key in K.LAUNCHES}
    want = ref.sdpa_ref(q, k, v, causal=causal, window=window)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    out = {"shape": [b, s, h, kvh, d, dv], "dtype": str(dtype).split(".")[-1],
           "causal": causal, "window": window, "qk_scale": qk_scale,
           "kernel": name if cuda else "plain",
           "loads": "tma" if K.tma_loads(dtype, d, dv) else "warp",
           "plan": plan,
           "launches": launched, "tolerance": tol, **_error(got, want, tol)}
    if cuda:
        fns = {"ms": lambda _: K.launch(q, k, v, causal, name, window)}
        if window:
            fns["causal_ms"] = lambda _: K.launch(q, k, v, True, name)
        library = library_call(q, k, v, causal, window)
        fns["library_ms"] = lambda _: library()
        if split:   # the f32 wide instance's pre-pass on its own
            fns["split_ms"] = lambda _: K.split_launch(q, k, v)
        on_device = {key[:-2] + "device_ms": fn for key, fn in fns.items()}
        fns["plain_ms"] = lambda _: ref.sdpa_ref(q, k, v, causal,
                                                 window=window)
        out.update(in_turns(fns, reps, device))
        out.update(device_ms(on_device, reps, device))
    else:
        out["ms"] = time_ms(lambda: K.flash_attention_fwd(
            q, k, v, causal, window), reps)
        out["plain_ms"] = time_ms(lambda: ref.sdpa_ref(
            q, k, v, causal, window=window), reps)
        out["library_ms"] = None
    K.LAUNCHES.update(before)
    K.SPLIT_LAUNCHES.update(split_before)
    out.update(attention_bound(b, s, h, kvh, d, dv, dtype, causal, window))
    if split:
        out["split_bound_ms"] = split_bound(b, s, h, kvh, d, dv)["bound_ms"]
    if window:
        out["causal_bound_ms"] = attention_bound(b, s, h, kvh, d, dv, dtype,
                                                 True)["bound_ms"]
        if out.get("causal_device_ms"):
            out["causal_device_bound_share"] = (out["causal_bound_ms"]
                                                / out["causal_device_ms"])
    for key in ("ms", "library_ms", "plain_ms", "device_ms",
                "library_device_ms"):
        if out.get(key):
            out[key[:-2] + "bound_share"] = out["bound_ms"] / out[key]
    if out.get("device_ms") and out.get("library_device_ms"):
        # the kernel's device time over the library call's, in one call
        out["library_ratio"] = out["device_ms"] / out["library_device_ms"]
    return out


def split_bound(b: int, s: int, h: int, kvh: int, d: int, dv: int) -> Dict:
    """Least time of the f32 wide instance's pre-pass: q, k and v read once
    and its output (:func:`.kernel.split_floats` floats) written once, at
    the memory rate (it does no arithmetic worth a bound)."""
    n_bytes = 4 * (b * s * (h * d + kvh * d + kvh * dv)
                   + K.split_floats(b, s, h, kvh, d, dv))
    return {"bound_ms": n_bytes / H100_BYTES_PER_S * 1e3,
            "bound_bytes": n_bytes, "bound_by": "bytes"}


def check_tf32_split(b: int, s: int, h: int, kvh: int, d: int, dv: int,
                     seed: int, device, reps: int = 10,
                     misaligned: bool = False) -> Dict:
    """The f32 wide instance's pre-pass against its plain version
    (:func:`.ref.tf32_split`) on one seeded case, bit for bit
    (``mismatches``: elements whose bits differ); on the card also its
    device time beside its bytes bound and the plain version's time.
    ``misaligned`` puts q, k and v 4 bytes past a 16-byte boundary."""
    q, k, v = make_inputs(b, s, h, kvh, d, dv, torch.float32, seed, device)
    if misaligned:
        q, k, v = (_shifted(x) for x in (q, k, v))
    want = ref.tf32_split(q, k, v)
    out = {"shape": [b, s, h, kvh, d, dv], "misaligned": misaligned,
           **split_bound(b, s, h, kvh, d, dv)}
    if device.type != "cuda":
        got = want
    else:
        before = dict(K.SPLIT_LAUNCHES)
        got = K.split_launch(q, k, v)
        torch.cuda.synchronize(device)
        out.update(in_turns({"ms": lambda _: K.split_launch(q, k, v),
                             "plain_ms": lambda _: ref.tf32_split(q, k, v)},
                            reps, device))
        out.update(device_ms({"device_ms": lambda _: K.split_launch(q, k, v)},
                             reps, device))
        K.SPLIT_LAUNCHES.update(before)
        out["device_bound_share"] = out["bound_ms"] / out["device_ms"]
    out["mismatches"] = int((got.view(torch.int32)
                             != want.view(torch.int32)).sum())
    out["max_abs_err"] = float((got - want).abs().max()) if got.numel() \
        else 0.0
    return out


def _shifted(x):
    """x's values in a contiguous tensor that starts one element past an
    aligned allocation (4 bytes off 16 in f32)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y
