"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert, MoE 32 experts top-8,
vocab 49155. SwiGLU experts, RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, vocab_size=49155,
    num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, ffn_act="swiglu",
    num_experts=32, experts_per_token=8,
    layer_pattern=("attn",), ffn_pattern=("moe",),
    tie_embeddings=True,
)

TINY = ModelConfig(
    name="granite-moe-1b-a400m-tiny", family="moe",
    num_layers=2, d_model=64, vocab_size=503,
    num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, ffn_act="swiglu",
    num_experts=8, experts_per_token=2,
    layer_pattern=("attn",), ffn_pattern=("moe",),
    tie_embeddings=True,
)
