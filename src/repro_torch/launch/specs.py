"""Meta-tensor stand-ins for every (arch × shape) dry-run cell (counterpart
of repro.launch.specs).

``input_specs`` returns the argument trees the cell's step takes, as
tensors on the meta device: the reference's shapes and dtypes, no weight
drawn, no byte allocated. Modality frontends are stubs, as in the
reference: whisper gets precomputed frame embeddings, internvl precomputed
patch embeddings.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_init

PyTree = Any

# Archs whose size requires ZeRO-3/FSDP param sharding on the 256-rank mesh.
FSDP_ARCHS = {"llama4-scout-17b-a16e", "gemma2-9b", "qwen2.5-32b",
              "jamba-1.5-large-398b"}
# Archs whose optimizer moments drop to bf16 to fit a rank's memory.
BF16_MOMENT_ARCHS = {"jamba-1.5-large-398b", "llama4-scout-17b-a16e"}


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def opt_config_for(arch: str) -> AdamWConfig:
    if arch in BF16_MOMENT_ARCHS:
        return AdamWConfig(moment_dtype="bfloat16", master_dtype="float32")
    return AdamWConfig()


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        # the vision prefix counts toward the context length: text tokens
        # fill the remainder so prefill exactly fits the seq_len cache
        batch = {"tokens": meta((b, s - cfg.vision_prefix), torch.int32)}
        if cfg.vision_prefix:
            batch["vision_embeds"] = meta((b, cfg.vision_prefix, cfg.d_model),
                                          cfg.cdtype)
        if cfg.enc_dec:
            batch["audio_embeds"] = meta((b, s, cfg.d_model), cfg.cdtype)
        return batch
    # decode shapes: one new token against a seq_len cache
    return {"tokens": meta((b,), torch.int32),
            "position": meta((b,), torch.int32)}


def state_specs(model: LM, arch: str) -> tuple[PyTree, PyTree]:
    """(params, opt_state) on the meta device: AdamW's state built by
    ``adamw_init`` on the meta params."""
    params = model.param_shapes()
    return params, adamw_init(opt_config_for(arch), params)


def cache_specs(model: LM, cfg: ModelConfig, shape: ShapeConfig) -> PyTree:
    enc_len = shape.seq_len if cfg.enc_dec else 0
    return model.cache_shapes(shape.global_batch, shape.seq_len,
                              dtype=cfg.cdtype, enc_len=enc_len)


def input_specs(arch: str, shape: ShapeConfig, model: LM) -> dict:
    """Everything the cell's step consumes, on the meta device."""
    cfg = model.cfg
    params, opt = state_specs(model, arch)
    out = {"params": params}
    if shape.kind == "train":
        out["opt_state"] = opt
        out["batch"] = batch_specs(cfg, shape)
    else:  # prefill / decode / long_decode
        out["batch"] = batch_specs(cfg, shape)
        out["cache"] = cache_specs(model, cfg, shape)
    return out
