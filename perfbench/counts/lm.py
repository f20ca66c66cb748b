"""Operations and bytes a dense GQA decoder's work needs, from the shapes.

They count what the inputs need, not what the program happens to do: a
causal product over its lower triangle only, the head at the positions
whose logits are used, each input byte read once and each output byte
written once.  `dims` is `perfbench.reference.lm.dims`.
"""
from __future__ import annotations


def matmul_params(dm: dict) -> int:
    """Weights in the layers' products (q, k, v, o, gate, up, down)."""
    d, H, Hkv, hd, ff = dm["d"], dm["H"], dm["Hkv"], dm["hd"], dm["ff"]
    return dm["L"] * (d * H * hd * 2 + d * Hkv * hd * 2 + 3 * d * ff)


def head_params(dm: dict) -> int:
    return dm["d"] * dm["vocab"]


def causal_attn_flops(dm: dict, S: int) -> float:
    """One causal sequence of S tokens, every layer: QK^T and PV over the
    lower triangle, 2 * S^2 / 2 * hd each per head."""
    return 2.0 * S * S * dm["H"] * dm["hd"] * dm["L"]


def train_step_flops(dm: dict, B: int, S: int) -> float:
    """A training step of B sequences of S tokens: the forward's products
    (layers, head at every position, causal attention) three times over,
    forward and backward; recomputation is not needed work."""
    fwd = 2.0 * B * S * (matmul_params(dm) + head_params(dm)) + B * causal_attn_flops(dm, S)
    return 3.0 * fwd


def prefill_flops(dm: dict, S: int) -> float:
    """A prompt of S tokens: the layers' products at every position, causal
    attention, the head at the last position (the only logits used)."""
    return 2.0 * S * matmul_params(dm) + causal_attn_flops(dm, S) + 2.0 * head_params(dm)


def decode_flops(dm: dict, n_valid: int) -> float:
    """One token decoded against ``n_valid`` cached positions (its own
    prompt and earlier tokens, the new one included)."""
    attn = 4.0 * n_valid * dm["H"] * dm["hd"] * dm["L"]
    return 2.0 * (matmul_params(dm) + head_params(dm)) + attn


def flash_prefill_flops(dm: dict, S: int) -> float:
    """The prefill attention kernel's needed work over all layers."""
    return causal_attn_flops(dm, S)


def flash_prefill_bytes(dm: dict, S: int, elem: int = 2) -> float:
    """q, k, v read once and the output written once, every layer."""
    return float(S * (2 * dm["H"] + 2 * dm["Hkv"]) * dm["hd"] * elem * dm["L"])


def decode_attn_bytes(dm: dict, n_valid: int, elem: int = 2) -> float:
    """One sequence's decode attention over all layers: its ``n_valid``
    cached rows of K and V, its query and its output."""
    kv = 2.0 * n_valid * dm["Hkv"] * dm["hd"] * elem
    qo = 2.0 * dm["H"] * dm["hd"] * elem
    return (kv + qo) * dm["L"]
