"""qwen2.5-32b — 64L d5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias
[hf:Qwen/Qwen2.5 family]."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
        vocab=152064, head_dim=128,
        pattern=(LayerSpec(kind="attn"),),
        qkv_bias=True, rope_theta=1000000.0, tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="attn"),),
        qkv_bias=True, tie_embeddings=False, max_seq_len=128,
    )
