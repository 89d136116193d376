"""jamba-1.5-large-398b — 72L d8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
Mamba:attention 7:1 interleave, MoE 16e top-2 every other layer
[arXiv:2403.19887]."""
from repro_torch.configs.base import (LayerSpec, MambaConfig, ModelConfig,
                                      MoEConfig)

_PERIOD = tuple(
    LayerSpec(kind=("attn" if i == 3 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
        vocab=65536, head_dim=128,
        pattern=_PERIOD,
        moe=MoEConfig(n_experts=16, top_k=2),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=256, head_dim=16,
        pattern=_PERIOD,
        moe=MoEConfig(n_experts=4, top_k=2),
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2, chunk=16),
        tie_embeddings=False, max_seq_len=128,
    )
