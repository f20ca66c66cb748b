"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887; hf].

Hybrid Mamba+attention at 1:7 interleave (1 attention layer per 8-layer
block), MoE (16 experts, top-2) every other layer.  72L, d_model 8192,
64 query heads / 8 KV heads (GQA), d_ff 24576, vocab 65536.

Mamba layers use the SSD chunked formulation (repro_torch.models.mamba)
with the published d_state=16, d_conv=4, expand=2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=("attn",) + ("mamba",) * 7,   # 1:7 attn:mamba
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_every=2,                                 # MoE every other layer
    mamba_expand=2,
    mamba_d_state=16,
    mamba_head_dim=64,
    mamba_d_conv=4,
    mamba_chunk=256,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        block_pattern=("attn",) + ("mamba",) * 7,
        n_experts=4,
        experts_per_token=2,
        moe_d_ff=64,
        moe_every=2,
        mamba_expand=2,
        mamba_d_state=8,
        mamba_head_dim=16,
        mamba_d_conv=4,
        mamba_chunk=16,
        attn_impl="naive",
    )
