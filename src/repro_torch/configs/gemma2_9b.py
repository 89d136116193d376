"""gemma2-9b — 42L d3584 16H (GQA kv=8) d_ff=14336 vocab=256000; alternating
local(4096)/global attention, attn softcap 50, final softcap 30
[arXiv:2408.00118]."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
        vocab=256000, head_dim=256,
        pattern=(LayerSpec(kind="attn_local"), LayerSpec(kind="attn")),
        local_window=4096, attn_softcap=50.0, final_softcap=30.0,
        act="gelu", embed_scale=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="attn_local"), LayerSpec(kind="attn")),
        local_window=16, attn_softcap=50.0, final_softcap=30.0,
        act="gelu", embed_scale=True, tie_embeddings=True, max_seq_len=128,
    )
