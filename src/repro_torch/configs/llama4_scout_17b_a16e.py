"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
48L, d_model 5120, 40H / 8 KV heads, expert d_ff 8192, vocab 202048;
MoE 16 routed experts top-1 + 1 shared expert per layer.  Early-fusion
multimodal frontend is out of scope for the assigned LM shapes (DESIGN.md §6);
the text backbone is exercised.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    moe_every=1,
    rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-reduced",
        family="moe",
        n_layers=2,
        d_model=80,
        n_heads=5,
        n_kv_heads=1,
        d_ff=64,
        vocab_size=512,
        n_experts=4,
        experts_per_token=1,
        n_shared_experts=1,
        moe_d_ff=64,
        moe_every=1,
        attn_impl="naive",
    )
