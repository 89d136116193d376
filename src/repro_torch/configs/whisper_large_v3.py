"""whisper-large-v3 — enc-dec, 32L d1280 20H d_ff=5120 vocab=51866; conv
frontend is a stub: the encoder takes precomputed frame embeddings
[arXiv:2212.04356]."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
        vocab=51866, head_dim=64,
        pattern=(LayerSpec(kind="attn"),),
        enc_dec=True, n_enc_layers=32, audio_frontend=True,
        norm="layernorm", act="gelu", rope_fraction=0.0,
        tie_embeddings=True, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, head_dim=16,
        pattern=(LayerSpec(kind="attn"),),
        enc_dec=True, n_enc_layers=2, audio_frontend=True,
        norm="layernorm", act="gelu", rope_fraction=0.0,
        tie_embeddings=True, max_seq_len=128,
    )
