"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — MLA (multi-head latent attention).

62L d_model=2560 40H d_ff=6400 vocab=73448. MLA dims from the HF config:
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, vocab_size=73448,
    num_heads=40, num_kv_heads=40, head_dim=64,
    attn_type="mla",
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    d_ff=6400, ffn_act="swiglu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
)

TINY = ModelConfig(
    name="minicpm3-tiny", family="dense",
    num_layers=2, d_model=64, vocab_size=251,
    num_heads=4, num_kv_heads=4, head_dim=16,
    attn_type="mla",
    q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    d_ff=128, ffn_act="swiglu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
)
