"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG`` (the published config) and ``TINY`` (a
reduced same-family config for CPU tests), field for field the
reference's. ``ARCH_IDS`` lists every architecture; ``ALIASES`` maps the
external ids onto them.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCH_IDS = [
    "granite_moe_1b",
    "phi35_moe_42b",
    "minicpm3_4b",
    "starcoder2_7b",
    "llama32_3b",
    "nemotron4_340b",
    "llava_next_mistral_7b",
    "mamba2_2p7b",
    "musicgen_large",
    "jamba15_large_398b",
]

# external ids (from the assignment table) → module names
ALIASES = {
    "granite-moe-1b-a400m": "granite_moe_1b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "minicpm3-4b": "minicpm3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "llama3.2-3b": "llama32_3b",
    "nemotron-4-340b": "nemotron4_340b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mamba2-2.7b": "mamba2_2p7b",
    "musicgen-large": "musicgen_large",
    "jamba-1.5-large-398b": "jamba15_large_398b",
}


def get_config(arch: str, tiny: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; expected one of "
                         f"{ARCH_IDS} or an alias")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.TINY if tiny else mod.CONFIG


def all_configs(tiny: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, tiny) for a in ARCH_IDS}
