"""nemotron-4-340b [arXiv:2402.16819] — GQA, squared-ReLU FFN.

96L d_model=18432 96H (GQA kv=8) head_dim=192 d_ff=73728 vocab=256000.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, vocab_size=256000,
    num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, ffn_act="squared_relu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
)

TINY = ModelConfig(
    name="nemotron-tiny", family="dense",
    num_layers=2, d_model=96, vocab_size=512,
    num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=384, ffn_act="squared_relu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
)
