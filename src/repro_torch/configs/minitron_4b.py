"""Minitron-4B [arXiv:2407.14679; hf]: width/depth-pruned Nemotron, dense GQA.
32L, d_model 3072, 24H / 8 KV heads, d_ff 9216, vocab 256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-reduced",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=1024,   # tiny stand-in for the 256k table
        attn_impl="naive",
    )
