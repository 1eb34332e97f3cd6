"""Assigned architecture configs.  Each module exports ``CONFIG`` (the exact
published shape) and ``smoke_config()`` (a reduced same-family shape).

``get_config(arch_id)`` resolves by id (dashes or underscores).
"""

from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = [
    "gemma-2b",
    "gemma3-1b",
    "qwen1.5-4b",
    "qwen3-14b",
    "arctic-480b",
    "qwen3-moe-235b-a22b",
    "zamba2-7b",
    "internvl2-26b",
    "rwkv6-3b",
    "whisper-large-v3",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.smoke_config()
