"""Uniform model API, twin of `repro.models.api`, for decoder-only configs.

    model = get_model(cfg)
    params = model.init_params(seed=0, device=None)   # None: the CUDA card
    logits, cache = model.prefill(params, {"tokens": tokens})          # [B, 1, V]
    logits, cache = model.decode_step(params, cache, tokens, cache_len)

An encoder-decoder config raises `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_params(self, seed: int = 0, device=None) -> dict:
        """Random parameters drawn on ``device`` from a `torch.Generator`
        seeded with ``seed``, in ``cfg.dtype``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return lm.lm_init(nn.InitCtx(gen=gen, dtype=self.cfg.torch_dtype), self.cfg)

    @torch.no_grad()
    def prefill(self, params, batch):
        """(last-position logits [B, 1, V], cache [n_layers, B, S, Hkv, hd])."""
        return lm.lm_forward(params, self.cfg, batch, "prefill")

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, cache_len):
        """(logits [B, 1, V], cache): ``tokens`` [B, 1] at position
        ``cache_len`` for every row; the cache is updated in place."""
        return lm.lm_forward(params, self.cfg, {"tokens": tokens}, "decode", cache, cache_len)

    def init_cache(self, batch: int, cap: int, device=None) -> dict:
        return lm.lm_init_cache(self.cfg, batch, cap, resolve_device(device))

    def cache_axes(self) -> dict:
        return lm.lm_cache_axes(self.cfg)


def get_model(cfg: ModelConfig) -> Model:
    lm.check_supported(cfg)
    return Model(cfg=cfg)
