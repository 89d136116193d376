"""Architecture configuration schema (own copy of repro.configs.base).

The fields and their defaults are those of the reference, so that a config
built here equals the reference's field by field. What differs: the
submodule configs of the unported families are untyped placeholders;
``pdtype``/``cdtype`` map the dtype strings to ``torch.dtype``, and
``param_count`` covers the dense layer kinds this package runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""

    kind: str = "attn"            # attn | attn_local | mla | mamba | rwkv
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 → d_model // n_heads
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    # --- attention options
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # stablelm partial rotary
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None
    # serving: local (sliding-window) layers keep a window-sized ring cache
    ring_local_cache: bool = False
    # --- submodule configs of the families not ported yet (always None in
    # the three dense archs here; kept so the fields match the reference)
    moe: Optional[object] = None
    mla: Optional[object] = None
    mamba: Optional[object] = None
    rwkv: Optional[object] = None
    # --- encoder/decoder
    enc_dec: bool = False
    n_enc_layers: int = 0
    # --- vlm stub
    vision_prefix: int = 0
    audio_frontend: bool = False
    # --- misc
    act: str = "silu"             # silu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = True
    embed_scale: bool = False     # gemma-style sqrt(d_model) embedding scale
    max_seq_len: int = 524_288
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def param_count(self) -> int:
        """Analytic parameter count of a dense attention model."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        for spec in self.pattern:
            if spec.kind not in ("attn", "attn_local") or spec.moe:
                raise NotImplementedError(spec)
            qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            total += self.n_periods * (qkv + self.n_heads * hd * d + 3 * d * ff)
        return total
