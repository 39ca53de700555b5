"""Model configuration schema (the port's own copy of the reference's).

One :class:`ModelConfig` describes a decoder-only LM backbone composed of a
repeating *group* of layers (``layer_pattern``), each layer being an
``attn``/``mla``/``ssm`` token mixer followed by a ``dense``/``moe``/``none``
channel mixer (``ffn_pattern``). Homogeneous models use a group of size 1;
Jamba's 1:7 attn:mamba interleave with MoE-every-other-layer uses a group of
8. The schema keeps every field so configurations read the same in both
packages. :class:`ShapeConfig` names an input-shape cell (``SHAPES``;
``shapes_for`` gives an architecture's), as the dry-run sweeps them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    vocab_size: int
    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    attn_type: str = "gqa"           # gqa|mla (per-layer kinds come from
                                     # layer_pattern; this picks the variant)
    # ---- MLA (MiniCPM3 / DeepSeek-style) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # ---- FFN ----
    d_ff: int = 0
    ffn_act: str = "swiglu"          # swiglu|gelu|squared_relu
    # ---- MoE ----
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # ---- SSM (Mamba-2 / SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    # ---- layer layout ----
    layer_pattern: Tuple[str, ...] = ("attn",)     # attn|ssm per group slot
    ffn_pattern: Tuple[str, ...] = ("dense",)      # dense|moe|none per slot
    # ---- embeddings / head ----
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # ---- modality frontend stubs ----
    frontend: str = "none"           # none|vision_stub|audio_stub
    num_patches: int = 0             # vision stub: prefix length of embeds
    # ---- misc ----
    dtype: str = "bfloat16"
    sliding_window: int = 0          # 0 = full attention
    subquadratic: bool = False       # may run long_500k decode
    # ---- perf options (in the port both attn_impl values run one kernel) ----
    attn_impl: str = "dense"         # dense | chunked (online-softmax tiles)
    attn_q_chunk: int = 256
    attn_kv_chunk: int = 128
    opt_conv_split: bool = False     # SSM: per-stream convs (no concat AG)
    opt_bf16_grads: bool = False     # bf16 cotangents across MoE a2a

    def __post_init__(self):
        g = len(self.layer_pattern)
        if self.num_layers % g != 0:
            raise ValueError(f"{self.name}: num_layers {self.num_layers} "
                             f"not a multiple of group size {g}")
        if len(self.ffn_pattern) != g:
            raise ValueError(f"{self.name}: ffn_pattern length must equal "
                             f"layer_pattern length")

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 so the vocab dim shards
        evenly over any TP degree ≤256 (MaxText/Megatron convention).
        Logits beyond ``vocab_size`` are masked to -inf in ``lm_logits``."""
        return -(-self.vocab_size // 256) * 256

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def group_size(self) -> int:
        return len(self.layer_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def qk_head_dim(self) -> int:
        if self.attn_type == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D if self.tie_embeddings else 2 * V * D
        total += D  # final norm
        for kind, ffn in zip(self.layer_pattern, self.ffn_pattern):
            n = self.num_groups
            if kind == "attn":
                if self.attn_type == "mla":
                    qk = self.qk_nope_dim + self.qk_rope_dim
                    total += n * (D * self.q_lora_rank
                                  + self.q_lora_rank * self.num_heads * qk
                                  + D * (self.kv_lora_rank + self.qk_rope_dim)
                                  + self.kv_lora_rank * self.num_heads
                                  * (self.qk_nope_dim + self.v_head_dim)
                                  + self.num_heads * self.v_head_dim * D
                                  + self.q_lora_rank + self.kv_lora_rank + D)
                else:
                    hd = self.head_dim
                    total += n * (D * self.num_heads * hd
                                  + 2 * D * self.num_kv_heads * hd
                                  + self.num_heads * hd * D + D)
            elif kind == "ssm":
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += n * (D * (2 * di + 2 * ds + nh)
                              + self.conv_width * (di + 2 * ds)
                              + 3 * nh + di + di * D + D)
            if ffn == "dense":
                mats = 3 if self.ffn_act == "swiglu" else 2
                total += self.num_groups * (mats * D * F + D)
            elif ffn == "moe":
                mats = 3 if self.ffn_act == "swiglu" else 2
                total += self.num_groups * (self.num_experts * mats * D * F
                                            + D * self.num_experts + D)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        total = self.param_count()
        mats = 3 if self.ffn_act == "swiglu" else 2
        for kind, ffn in zip(self.layer_pattern, self.ffn_pattern):
            if ffn == "moe":
                dead = (self.num_experts - self.experts_per_token)
                total -= self.num_groups * dead * mats * self.d_model * self.d_ff
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a sequence length, a global batch and the
    kind of step (``train`` | ``prefill`` | ``decode``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig):
    """The shape cells an architecture runs: ``long_500k`` only for a
    sub-quadratic one."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return out
