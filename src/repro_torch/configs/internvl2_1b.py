"""InternVL2-1B [arXiv:2404.16821; hf]: InternViT-300M + Qwen2-0.5B-style
LM backbone (24L, d_model 896, 14H / 2 KV heads, d_ff 4864, vocab 151655).
The InternViT frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings [B, 256, 896] prefixed to the text tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    qkv_bias=True,
    n_vision_tokens=256,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-reduced",
        family="vlm",
        n_layers=2,
        d_model=56,
        n_heads=7,
        n_kv_heads=1,
        d_ff=112,
        vocab_size=512,
        head_dim=8,
        qkv_bias=True,
        n_vision_tokens=8,
        attn_impl="naive",
    )
