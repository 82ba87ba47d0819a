"""System presets and the LM architecture registry.

``tm_iris`` and ``tm_mnist`` are the Tsetlin Machine presets on the port's
own ``TMConfig``. The LM registry mirrors the reference's: one module per
assigned architecture (copies, plain data); ``get_config(arch_id)`` returns
the full-size config and ``get_smoke_config(arch_id)`` the reduced
same-family config the CPU tests use. Every config loads, and the port
builds models of every family.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES  # noqa: F401

ARCH_IDS = [
    "llama32_vision_11b",
    "recurrentgemma_9b",
    "granite_8b",
    "gemma3_1b",
    "phi3_medium_14b",
    "qwen25_14b",
    "musicgen_medium",
    "arctic_480b",
    "olmoe_1b_7b",
    "mamba2_780m",
]

# brief ids (with dots/dashes) -> module names
ALIASES = {
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-8b": "granite_8b",
    "gemma3-1b": "gemma3_1b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2.5-14b": "qwen25_14b",
    "musicgen-medium": "musicgen_medium",
    "arctic-480b": "arctic_480b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-780m": "mamba2_780m",
}


def _module(arch_id: str):
    name = ALIASES.get(arch_id, arch_id)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
