"""Architecture configuration schema (own copy of repro.configs.base).

The fields and their defaults are those of the reference, so that a config
built here equals the reference's field by field. What differs:
``pdtype``/``cdtype`` map the dtype strings to ``torch.dtype``, and
``param_count`` is the reference's formula, term for term (its
encoder-decoder term counts three d x d_ff matrices a layer, where
whisper's classic MLP has two: it overcounts the weights that
``LM.init_params`` draws, as the reference's does).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 → ceil(d_model / 16)
    chunk: int = 128          # scan chunk for the selective scan


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    chunk: int = 64


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
    # --- submodule configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
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

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode? SSM/hybrid: yes (attention
        layers in hybrids keep a full KV cache; pure full-attention: no)."""
        return all(s.kind in ("mamba", "rwkv") for s in self.pattern) or \
            any(s.kind in ("mamba", "rwkv") for s in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), term for term as
        the reference's."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        n = self.n_periods
        total = v * d * (1 if self.tie_embeddings else 2)
        for spec in self.pattern:
            if spec.kind in ("attn", "attn_local"):
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                total += n * (qkv + self.n_heads * hd * d)
            elif spec.kind == "mla":
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += n * (
                    d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_head
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
            elif spec.kind == "mamba":
                mb = self.mamba
                di = mb.expand * d
                dtr = mb.dt_rank or -(-d // 16)
                total += n * (d * 2 * di + di * mb.d_conv
                              + di * (dtr + 2 * mb.d_state) + dtr * di
                              + di * mb.d_state + di + di * d)
            elif spec.kind == "rwkv":
                # r, k, v, g, o and the decay LoRA; the channel mix's two
                # matrices below (cm_r is not counted, as in the reference)
                total += n * (5 * d * d + 2 * d * self.rwkv.decay_lora
                              + 2 * d * ff)
                continue
            else:
                raise NotImplementedError(spec)
            if spec.moe and self.moe is not None:
                total += n * (d * self.moe.n_experts
                              + self.moe.n_experts * 3 * d * ff)
            else:
                total += n * 3 * d * ff
        if self.enc_dec:
            # encoder blocks + cross attention in decoder
            qkv = 4 * d * (self.n_heads * hd)
            total += self.n_enc_layers * (qkv + 3 * d * ff)
            total += self.n_layers * qkv  # cross-attn in each decoder layer
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = sum(
            self.n_periods * (self.moe.n_experts - self.moe.top_k) * 3 * d * ff
            for spec in self.pattern if spec.moe)
        return self.param_count() - inactive
