"""Whisper-tiny [arXiv:2212.04356; unverified]: enc-dec audio backbone.
4L enc + 4L dec, d_model 384, 6H (MHA), d_ff 1536, vocab 51865, head_dim 64.
Conv/mel frontend is a STUB: input_specs() supplies precomputed frame
embeddings [B, 1500, 384].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    n_audio_frames=1500,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        is_encoder_decoder=True,
        n_encoder_layers=2,
        n_audio_frames=24,
        attn_impl="naive",
    )
