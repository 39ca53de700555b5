"""musicgen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA, kv=32) d_ff=8192 vocab=2048 (codebook size).
The EnCodec frontend is a stub: the caller passes precomputed codec-frame
embeddings for the conditioning prefix (``Model.prefill(frontend_embeds=
...)``); the backbone is a plain decoder over audio tokens (GELU FFN, the
learned absolute positions replaced by RoPE, as in the reference).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, vocab_size=2048,
    num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, ffn_act="gelu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
    frontend="audio_stub", num_patches=128,
)

TINY = ModelConfig(
    name="musicgen-tiny", family="audio",
    num_layers=2, d_model=64, vocab_size=256,
    num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, ffn_act="gelu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
    frontend="audio_stub", num_patches=8,
)
