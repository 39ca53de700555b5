"""mamba2-2.7b [arXiv:2405.21060] — SSD (state-space duality), attn-free.

64L d_model=2560, d_inner=5120 (expand 2), d_state=128, headdim=64
(→ 80 SSM heads), vocab=50280. Sub-quadratic → runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    layer_pattern=("ssm",), ffn_pattern=("none",),
    tie_embeddings=True, subquadratic=True,
)

TINY = ModelConfig(
    name="mamba2-tiny", family="ssm",
    num_layers=2, d_model=64, vocab_size=379,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=32,
    layer_pattern=("ssm",), ffn_pattern=("none",),
    tie_embeddings=True, subquadratic=True,
)
