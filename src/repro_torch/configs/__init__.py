"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full (paper-exact) ModelConfig;
``get_smoke_config(name)`` returns the reduced same-family config used by
CPU smoke tests (small widths/layers/experts, tiny vocab).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "xlstm_1_3b",
    "qwen2_vl_72b",
    "mistral_nemo_12b",
    "codeqwen1_5_7b",
    "yi_6b",
    "qwen1_5_4b",
    "grok_1_314b",
    "qwen2_moe_a2_7b",
    "jamba_1_5_large_398b",
    "whisper_tiny",
]

# CLI-facing ids (match the assignment spelling)
ALIASES = {
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "yi-6b": "yi_6b",
    "qwen1.5-4b": "qwen1_5_4b",
    "grok-1-314b": "grok_1_314b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-tiny": "whisper_tiny",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
