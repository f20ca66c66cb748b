"""DeepSeek-MoE-16B [arXiv:2401.06066; hf]: fine-grained MoE.
28L, d_model 2048, 16H / 16 KV heads (MHA), expert d_ff 1408, vocab 102400;
2 shared + 64 routed experts, top-6; layer 0 keeps a dense FFN (d_ff 10944).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    moe_every=1,
    first_k_dense=1,
    dense_d_ff=10944,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-reduced",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab_size=512,
        n_experts=8,
        experts_per_token=2,
        n_shared_experts=2,
        moe_d_ff=32,
        moe_every=1,
        first_k_dense=1,
        dense_d_ff=128,
        attn_impl="naive",
    )
