"""FFN layers, twin of `repro.models.mlp`: the dense SwiGLU.

The port serves the dense decoder family; a MoE layer
(``cfg.layer_is_moe(i)``) raises `NotImplementedError` (`ROADMAP.md`
queue 1, item 11).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn


def dense_ffn_init(ctx: nn.InitCtx, cfg: ModelConfig, hidden: int, n_layers: int) -> dict:
    """SwiGLU weights of ``n_layers`` layers, stacked on a leading axis."""
    d, n = cfg.d_model, n_layers
    return {
        "w_gate": nn.fan_in_normal(ctx, (n, d, hidden), fan_in=d),
        "w_up": nn.fan_in_normal(ctx, (n, d, hidden), fan_in=d),
        "w_down": nn.fan_in_normal(ctx, (n, hidden, d), fan_in=hidden),
    }


def dense_ffn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return nn.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _no_moe(cfg: ModelConfig, layer_idx: int) -> None:
    if cfg.layer_is_moe(layer_idx):
        raise NotImplementedError(
            f"repro_torch: layer {layer_idx} of {cfg.name} is a MoE layer; the MoE FFN is "
            "not ported yet (ROADMAP.md queue 1, item 11)"
        )


def ffn_init(ctx: nn.InitCtx, cfg: ModelConfig, layer_idx: int, n_layers: int) -> dict:
    _no_moe(cfg, layer_idx)
    return {"dense": dense_ffn_init(ctx, cfg, cfg.ffn_hidden(layer_idx), n_layers)}


def ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "dense" not in p:
        raise NotImplementedError("repro_torch: only the dense FFN is ported")
    return dense_ffn_apply(p["dense"], x)
