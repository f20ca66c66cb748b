"""Qwen2-7B [arXiv:2407.10671; hf]: dense GQA with QKV bias.
28L, d_model 3584, 28H / 4 KV heads, d_ff 18944, vocab 152064."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-reduced",
        family="dense",
        n_layers=2,
        d_model=56,
        n_heads=7,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        attn_impl="naive",
    )
