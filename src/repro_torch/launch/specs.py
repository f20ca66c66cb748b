"""Input stand-ins for every (arch x shape) cell, twin of `repro.launch.specs`.

Empty tensors on the ``meta`` device with the reference's shapes and dtypes
(its `ShapeDtypeStruct`s): no memory, nothing drawn; the dry-run runs its
steps on them.  For decode shapes the KV/state cache itself is part of the
input signature (`Model.init_cache` on meta), so decode runs
`Model.decode_step` (one new token against a seq_len cache), not a train
step.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, Shape, get_config
from repro_torch.models.api import Model, get_model
from repro_torch.models.config import ModelConfig

# logical axes of each batch field (for the batch's specs)
BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "patches": ("batch", "seq", "embed"),
    "frames": ("batch", "frames", "embed"),
}

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _extras(cfg: ModelConfig, B: int) -> dict:
    out = {}
    if cfg.n_vision_tokens:
        out["patches"] = _meta((B, cfg.n_vision_tokens, cfg.d_model), torch.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = _meta((B, cfg.n_audio_frames, cfg.d_model), torch.float32)
    return out


def train_specs(cfg: ModelConfig, shape: Shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_vision_tokens:
        S = S - cfg.n_vision_tokens            # total positions == seq_len
    batch = {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
    }
    batch.update(_extras(cfg, B))
    return batch


def prefill_specs(cfg: ModelConfig, shape: Shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_vision_tokens:
        S = S - cfg.n_vision_tokens
    batch = {"tokens": _meta((B, S), torch.int32)}
    batch.update(_extras(cfg, B))
    return batch


def decode_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """Returns {cache, tokens, cache_len} stand-ins."""
    model: Model = get_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    return {
        "cache": model.init_cache(B, S, device=META),
        "tokens": _meta((B, 1), torch.int32),
        "cache_len": _meta((), torch.int32),
    }


def input_specs(arch_or_cfg, shape_name: str) -> dict:
    cfg = arch_or_cfg if isinstance(arch_or_cfg, ModelConfig) else get_config(arch_or_cfg)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)
