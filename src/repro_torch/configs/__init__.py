"""Architecture registry: one module per assigned architecture.

Each module defines CONFIG (the exact published configuration) and
SMOKE (a reduced same-family config for CPU smoke tests).

The port's own copy of ``repro.configs`` (plain data, so ids resolve the
same way in both packages); ``tests/test_torch_models.py`` holds the two
equal.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCHS = [
    "h2o_danube_1_8b",
    "qwen2_5_32b",
    "gemma_7b",
    "granite_8b",
    "qwen2_moe_a2_7b",
    "qwen3_moe_235b_a22b",
    "zamba2_7b",
    "rwkv6_3b",
    "internvl2_76b",
    "musicgen_large",
]

# canonical --arch ids (dashes, as listed in the assignment)
ARCH_IDS = [a.replace("_", "-").replace("-1-8b", "-1.8b").replace("-2-5-", "-2.5-")
            .replace("-a2-7b", "-a2.7b") for a in ARCHS]


def _mod(name: str):
    return importlib.import_module(f".{name}", __package__)


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    return _mod(canon(arch)).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(canon(arch)).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
