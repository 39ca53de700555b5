"""Plain PyTorch version of the flash-attention kernel: dense SDPA with GQA
grouping and an f32 softmax.

It follows the reference's precision steps: scores in f32 (products of
the inputs accumulated in f32), the softmax in f32, probabilities cast to
``v.dtype``, the PV product accumulated in f32, the output in
``v.dtype``. Any ``s`` is taken. Decode calls it too, with one query
against a cache of ``t`` rows and an additive mask in place of the causal
one.
"""
from __future__ import annotations

import torch

NEG = -1e30


def sdpa_ref(q, k, v, causal: bool = True, mask=None):
    """q: (b, s, h, d); k/v: (b, t, kvh, d/dv) → (b, s, h, dv). ``causal``
    needs ``t == s``; ``mask`` (f32, additive) broadcasts against (s, t)."""
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
        scores = torch.where(keep, scores, torch.tensor(NEG, dtype=f32,
                                                        device=q.device))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(f32), v.to(f32))
    return out.reshape(b, s, h, dv).to(v.dtype)
