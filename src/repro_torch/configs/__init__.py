"""Config registry: ``--arch <id>`` resolution for the ten archs of the
reference, and the assigned shape grid (own copy of repro.configs). Every
arch runs through ``LM``; ``ServeSession`` takes token prompts only and
refuses internvl2-1b's and whisper-large-v3's, as the reference's does."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (LayerSpec, MambaConfig, MLAConfig,
                                      ModelConfig, MoEConfig, RWKVConfig)

ARCHS: dict[str, str] = {
    "stablelm-3b": "stablelm_3b",
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "minicpm3-4b": "minicpm3_4b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-1b": "internvl2_1b",
    "whisper-large-v3": "whisper_large_v3",
}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode | long_decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").config()


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke()


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic (SSM/hybrid) archs — full-attention
    archs skip it."""
    if shape.kind == "long_decode":
        return cfg.family in ("ssm", "hybrid")
    return True


def grid(arch: str) -> list[ShapeConfig]:
    cfg = get_config(arch)
    return [s for s in SHAPES.values() if shape_applicable(cfg, s)]


__all__ = ["ARCHS", "SHAPES", "ShapeConfig", "LayerSpec", "MLAConfig",
           "MambaConfig", "ModelConfig", "MoEConfig", "RWKVConfig",
           "get_config", "get_smoke_config", "shape_applicable", "grid"]
