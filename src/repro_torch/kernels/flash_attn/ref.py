"""Plain PyTorch version of the flash-attention kernel: dense SDPA with GQA
grouping and an f32 softmax.

It follows the reference's precision steps: scores in f32 (products of
the inputs accumulated in f32), the softmax in f32, probabilities cast to
``v.dtype``, the PV product accumulated in f32, the output in
``v.dtype``. Any ``s`` is taken. ``window`` > 0 (sliding-window attention,
causal only) keeps key j for query i iff ``i - window < j <= i``: the
reference's ``_causal_mask(s, s, 0, window)``. Decode and chunked prefill
call it too, with one query (or a chunk) against a cache of ``t`` rows
and an additive mask in place of the causal one.
"""
from __future__ import annotations

import torch

NEG = -1e30


def check_window(causal: bool, window: int) -> None:
    """Refuse a window that is negative or over non-causal attention."""
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window}: a sliding window is a "
                         f"non-negative width over causal attention")


def sdpa_ref(q, k, v, causal: bool = True, mask=None, window: int = 0):
    """q: (b, s, h, d); k/v: (b, t, kvh, d/dv) → (b, s, h, dv). ``causal``
    needs ``t == s``; ``window`` > 0 needs ``causal``. ``mask`` (f32,
    additive) broadcasts against the scores, (b, kvh, g, s, t): an (s, t)
    mask is shared by every row, a (b, 1, 1, 1, t) one is per row (packed
    decode)."""
    check_window(causal, window)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dv = v.shape[3]
    f32 = torch.float32
    qr = q.reshape(b, s, kvh, g, d).to(f32)
    scores = torch.einsum("bskgd,btkd->bkgst", qr, k.to(f32))
    scores = scores / torch.sqrt(torch.tensor(d, dtype=f32))
    if causal:
        pos = torch.arange(s, device=q.device)
        keep = pos[None, :] <= pos[:, None]
        if window:
            keep &= pos[None, :] > pos[:, None] - window
        scores = torch.where(keep, scores, torch.tensor(NEG, dtype=f32,
                                                        device=q.device))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(f32), v.to(f32))
    return out.reshape(b, s, h, dv).to(v.dtype)


def _tf32_cut(x):
    """x with its low 13 bits cleared (an f32 tensor)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_rna(x):
    """x rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties
    away from zero (half of the 13 dropped bits added to the magnitude,
    then cut)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def tf32_split(q, k, v):
    """Plain version of the f32 wide instance's pre-pass
    (``tf32_split_kernel``): one flat f32 tensor of ``kernel.split_floats``
    elements. q's and k's rows as (b, s, heads, 2 dp), dp = d rounded up to
    32: the hi part (the low 13 bits cleared) in columns [0, dp), the lo
    part tf32(x - hi) in [dp, 2 dp), zeros past d; then V^T as (b, kvh, 2,
    dv, s8), s8 = s rounded up to 8, hi then lo, keys along a row, zeros
    past s, within each 8 in the order 0 2 4 6 1 3 5 7 (:func:`split_key`:
    the order the kernel's P fragments read them in)."""
    b, s, h, d = q.shape
    dv = v.shape[3]
    dp, s8 = -(-d // 32) * 32, -(-s // 8) * 8
    pad = torch.nn.functional.pad

    def parts(x, last):
        hi = _tf32_cut(x)
        return torch.cat([hi, _tf32_rna(x - hi)], last)

    qs = parts(pad(q.float(), (0, dp - d)), -1)
    ks = parts(pad(k.float(), (0, dp - d)), -1)
    vt = pad(v.float().permute(0, 2, 3, 1), (0, s8 - s))   # (b, kvh, dv, s8)
    vt = vt[..., split_key(torch.arange(s8, device=v.device))]
    vt = parts(vt[:, :, None], 2)                           # hi, lo on dim 2
    assert vt.shape[2:] == (2, dv, s8)
    return torch.cat([qs.reshape(-1), ks.reshape(-1), vt.reshape(-1)])


def split_key(p):
    """The key at position ``p`` of the pre-pass's V^T (an int or a tensor
    of them): within each 8, keys 0 2 4 6 1 3 5 7."""
    return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1)
