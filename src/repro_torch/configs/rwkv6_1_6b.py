"""rwkv6-1.6b ("Finch") — 24L d2048 (attention-free) d_ff=7168 vocab=65536,
data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import LayerSpec, ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
        vocab=65536, head_dim=64,
        pattern=(LayerSpec(kind="rwkv"),),
        rwkv=RWKVConfig(head_size=64, decay_lora=64),
        norm="layernorm", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="rwkv"),),
        rwkv=RWKVConfig(head_size=16, decay_lora=8, chunk=16),
        norm="layernorm", tie_embeddings=False, max_seq_len=128,
    )
