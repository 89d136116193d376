"""minicpm3-4b — 62L d2560 40H d_ff=6400 vocab=73448, Multi-head Latent
Attention (MLA) [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
        vocab=73448, head_dim=96,
        pattern=(LayerSpec(kind="mla"),),
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, head_dim=24,
        pattern=(LayerSpec(kind="mla"),),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        tie_embeddings=True, max_seq_len=128,
    )
