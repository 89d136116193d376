"""granite-moe-1b-a400m — 24L d1024 16H (GQA kv=8) expert_ff=512 vocab=49155,
MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
        vocab=49155, head_dim=64,
        pattern=(LayerSpec(kind="attn", moe=True),),
        moe=MoEConfig(n_experts=32, top_k=8),
        rope_theta=10000.0, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="attn", moe=True),),
        moe=MoEConfig(n_experts=4, top_k=2),
        tie_embeddings=True, max_seq_len=128,
    )
