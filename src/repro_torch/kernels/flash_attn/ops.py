"""Flash attention: a CUDA kernel on the card, its plain version on the
CPU (:mod:`.kernel`, which picks the bf16 or the f32 tensor-core kernel by
dtype; both take every head width from 1 up); the dense version lives in
:mod:`.ref`."""
from __future__ import annotations

from .kernel import flash_attention_fwd
from .ref import sdpa_ref  # noqa: F401


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """The reference's ``ops.flash_attention`` without ``interpret``.

    ``block_q``/``block_k`` are the reference's tile sizes; they change
    only the order of its sums. The CUDA kernels' tiles are fixed by
    their designs (64 query rows and 64 keys, 32 keys for f32 heads wider
    than 128; d in chunks and o in slices of 512 or 256 columns for heads
    wider than 256), so here they are only checked."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got "
                         f"block_q={block_q}, block_k={block_k}")
    return flash_attention_fwd(q, k, v, causal=causal)
