"""stablelm-3b — 32L d2560 32H (kv=32) d_ff=6912 vocab=50304, partial rotary
(25%) [hf:stabilityai/stablelm-2 family]."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
        vocab=50304, head_dim=80,
        pattern=(LayerSpec(kind="attn"),),
        rope_fraction=0.25, norm="layernorm",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="attn"),),
        rope_fraction=0.25, norm="layernorm",
        tie_embeddings=False, max_seq_len=128,
    )
