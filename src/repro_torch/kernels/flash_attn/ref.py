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
