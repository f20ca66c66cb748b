"""Uniform model API, twin of `repro.models.api`, over every family.

    model = get_model(cfg)
    params = model.init_params(seed=0, device=None)   # None: the CUDA card
    meta = model.init_params(abstract=True)           # meta tensors, nothing drawn
    axes = model.param_axes()                         # logical axis names per leaf
    logits, cache = model.prefill(params, {"tokens": tokens})          # [B, 1, V]
    logits, cache = model.decode_step(params, cache, tokens, cache_len)
    loss, metrics = model.loss(params, {"tokens": tokens, "labels": labels})

An encoder-decoder config (``is_encoder_decoder``) runs
`repro_torch.models.whisper` and its prefill batch adds ``frames`` [B, F,
d]; a VLM config's adds ``patches`` [B, V, d]; every other config runs
`repro_torch.models.lm`.  `Model.loss` is differentiable (autograd);
`repro_torch.training.train_step` takes its gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models import lm, whisper
from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn


class _Family(NamedTuple):
    init: Callable           # (ctx, cfg) -> params
    forward: Callable        # (params, cfg, batch, mode, cache, cache_len) -> (logits, cache)
    loss: Callable           # (params, cfg, batch) -> (loss, metrics)
    init_cache: Callable     # (cfg, batch, cap, device) -> cache
    cache_axes: Callable     # (cfg) -> axes tree


_LM = _Family(lm.lm_init, lm.lm_forward, lm.lm_loss, lm.lm_init_cache, lm.lm_cache_axes)
_WHISPER = _Family(whisper.whisper_init, whisper.whisper_forward, whisper.whisper_loss,
                   whisper.whisper_init_cache, whisper.whisper_cache_axes)


def _family(cfg: ModelConfig) -> _Family:
    return _WHISPER if cfg.is_encoder_decoder else _LM


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_params(self, seed: int = 0, device=None, abstract: bool = False) -> dict:
        """Random parameters drawn on ``device`` from a `torch.Generator`
        seeded with ``seed``, in ``cfg.dtype``.  ``abstract``: empty tensors
        of the same shapes and dtypes on the ``meta`` device, nothing drawn
        and no device needed (the reference's ``abstract=True``)."""
        if abstract:
            ctx = nn.InitCtx(dtype=self.cfg.torch_dtype, abstract=True)
        else:
            gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
            ctx = nn.InitCtx(gen=gen, dtype=self.cfg.torch_dtype)
        return _family(self.cfg).init(ctx, self.cfg)

    def param_axes(self) -> dict:
        """The parameters' logical axis names, a tree like `init_params`'s
        with a tuple of names at each leaf: the reference's ``axes`` tree."""
        return _family(self.cfg).init(nn.InitCtx(dtype=self.cfg.torch_dtype, axes=True), self.cfg)

    def forward(self, params, batch, mode: str = "train", cache=None, cache_len=None):
        """The family's forward: ``train`` -> (logits at every position,
        aux), ``prefill`` / ``decode`` -> (logits, cache); autograd records
        it when grad mode is on."""
        return _family(self.cfg).forward(params, self.cfg, batch, mode, cache, cache_len)

    def loss(self, params, batch):
        """(loss, metrics): {"ce", "aux", "n_tokens"} for an LM (a MoE's
        load-balancing loss in "aux" and in the loss), {"ce", "n_tokens"}
        for whisper, as the reference."""
        return _family(self.cfg).loss(params, self.cfg, batch)

    @torch.no_grad()
    def prefill(self, params, batch):
        """(last-position logits [B, 1, V], the prompt's cache)."""
        return _family(self.cfg).forward(params, self.cfg, batch, "prefill")

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, cache_len):
        """(logits [B, 1, V], cache): ``tokens`` [B, 1] at position
        ``cache_len`` for every row; the cache is updated in place."""
        return _family(self.cfg).forward(params, self.cfg, {"tokens": tokens}, "decode", cache,
                                         cache_len)

    def init_cache(self, batch: int, cap: int, device=None) -> dict:
        return _family(self.cfg).init_cache(self.cfg, batch, cap, resolve_device(device))

    def cache_axes(self) -> dict:
        return _family(self.cfg).cache_axes(self.cfg)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
