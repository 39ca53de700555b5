"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B] — small llama3.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, tied embeddings,
rope_theta=500000.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, vocab_size=128256,
    num_heads=24, num_kv_heads=8, head_dim=128,
    rope_theta=500_000.0,
    d_ff=8192, ffn_act="swiglu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
    tie_embeddings=True,
)

TINY = ModelConfig(
    name="llama32-tiny", family="dense",
    num_layers=2, d_model=64, vocab_size=509,
    num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, ffn_act="swiglu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
    tie_embeddings=True,
)
