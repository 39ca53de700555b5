"""starcoder2-7b [arXiv:2402.19173] — GQA, RoPE, GELU FFN.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, vocab_size=49152,
    num_heads=36, num_kv_heads=4, head_dim=128,
    d_ff=18432, ffn_act="gelu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
)

TINY = ModelConfig(
    name="starcoder2-tiny", family="dense",
    num_layers=2, d_model=72, vocab_size=307,
    num_heads=6, num_kv_heads=2, head_dim=12,
    d_ff=288, ffn_act="gelu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
)
