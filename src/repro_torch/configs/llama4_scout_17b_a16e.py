"""llama4-scout-17b-a16e — 48L d5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 16 experts top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab=202048, head_dim=128,
        pattern=(LayerSpec(kind="attn", moe=True),),
        moe=MoEConfig(n_experts=16, top_k=1),
        rope_theta=500000.0, tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="attn", moe=True),),
        moe=MoEConfig(n_experts=4, top_k=1),
        tie_embeddings=False, max_seq_len=128,
    )
