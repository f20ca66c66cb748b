"""InternLM2-1.8B [arXiv:2403.17297; hf]: dense GQA decoder.
24L, d_model 2048, 16H / 8 KV heads, d_ff 8192, vocab 92544."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        attn_impl="naive",
    )
