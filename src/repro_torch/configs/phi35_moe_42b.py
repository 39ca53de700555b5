"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert, MoE 16 experts top-2,
vocab 32064. SwiGLU experts, RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, vocab_size=32064,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, ffn_act="swiglu",
    num_experts=16, experts_per_token=2,
    layer_pattern=("attn",), ffn_pattern=("moe",),
)

TINY = ModelConfig(
    name="phi3.5-moe-tiny", family="moe",
    num_layers=2, d_model=64, vocab_size=499,
    num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, ffn_act="swiglu",
    num_experts=4, experts_per_token=2,
    layer_pattern=("attn",), ffn_pattern=("moe",),
)
