"""jamba-1.5-large-398b [arXiv:2403.19887] — Mamba+attention 1:7, MoE 16e top-2.

72L d_model=8192; attention layers: 64H (GQA kv=8) head_dim=128; d_ff=24576;
vocab=65536. Layer group of 8 = [attn, ssm×7]; MoE every other layer
(4 of 8 slots). Mamba: d_inner=16384, d_state=128, headdim=64.
Sub-quadratic (1:7 attention) → runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, vocab_size=65536,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, ffn_act="swiglu",
    num_experts=16, experts_per_token=2,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    layer_pattern=("attn", "ssm", "ssm", "ssm", "ssm", "ssm", "ssm", "ssm"),
    ffn_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense",
                 "moe"),
    subquadratic=True,
)

TINY = ModelConfig(
    name="jamba-tiny", family="hybrid",
    num_layers=8, d_model=64, vocab_size=401,
    num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, ffn_act="swiglu",
    num_experts=4, experts_per_token=2,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=32,
    layer_pattern=("attn", "ssm", "ssm", "ssm", "ssm", "ssm", "ssm", "ssm"),
    ffn_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense",
                 "moe"),
    subquadratic=True,
)
