"""Yi-6B [arXiv:2403.04652; hf]: llama-architecture dense GQA.
32L, d_model 4096, 32H / 4 KV heads, d_ff 11008, vocab 64000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=160,
        vocab_size=512,
        attn_impl="naive",
    )
