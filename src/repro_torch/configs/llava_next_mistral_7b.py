"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000. The vision frontend is a stub: the caller passes precomputed
anyres patch embeddings, which replace the first ``num_patches``
positions of the text stream (``Model.prefill(frontend_embeds=...)``).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, vocab_size=32000,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, ffn_act="swiglu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
    frontend="vision_stub", num_patches=576,
)

TINY = ModelConfig(
    name="llava-next-tiny", family="vlm",
    num_layers=2, d_model=64, vocab_size=257,
    num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, ffn_act="swiglu",
    layer_pattern=("attn",), ffn_pattern=("dense",),
    frontend="vision_stub", num_patches=16,
)
