"""internvl2-1b — InternViT frontend (stubbed patch embeddings) + 24L d896
14H (GQA kv=2) d_ff=4864 vocab=151655 LM backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
        vocab=151655, head_dim=64,
        pattern=(LayerSpec(kind="attn"),),
        qkv_bias=True, vision_prefix=256, rope_theta=1000000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="attn"),),
        qkv_bias=True, vision_prefix=8, tie_embeddings=True, max_seq_len=128,
    )
