"""Config registry: ``--arch <id>`` resolution for the dense archs the port
serves (own copy of the relevant part of repro.configs)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import LayerSpec, ModelConfig

ARCHS: dict[str, str] = {
    "stablelm-3b": "stablelm_3b",
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-32b": "qwen2_5_32b",
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").config()


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke()


__all__ = ["ARCHS", "LayerSpec", "ModelConfig", "get_config",
           "get_smoke_config"]
