"""xLSTM-125M [arXiv:2405.04517; unverified]: alternating sLSTM + mLSTM.
12L, d_model 768, 4 heads, vocab 50304.  d_ff=0 per the assignment — xLSTM
blocks carry their own projection factors (mLSTM pf=2 up/gate, sLSTM
GLU pf=4/3) instead of a separate FFN.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    mlstm_chunk=256,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-reduced",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        block_pattern=("mlstm", "slstm"),
        mlstm_chunk=16,
    )
