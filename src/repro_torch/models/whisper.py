"""Whisper-style encoder-decoder (audio family), twin of
`repro.models.whisper`.

The conv/mel frontend is a stub, as in the reference: a request brings
frame embeddings [B, n_audio_frames, d_model] (what the two stride-2 convs
would emit).  The transformer is whole:

  encoder: bidirectional attention blocks over the frames (the sinusoidal
           table added, and RoPE inside self-attention, as the reference)
  decoder: causal self-attention, cross-attention to the encoder's output,
           SwiGLU FFN

Parameters are the reference's tree: ``embed``, ``enc_blocks`` and
``dec_blocks`` (each tensor stacked on a leading layer axis), ``enc_norm``,
``dec_norm``, ``head``.  The cache is ``{"dec": {"self": (k, v), "cross":
(k, v)}}`` with a leading [n_layers] axis: the decoder's growing
self-attention K/V [B, cap, Hkv, hd] and the cross-attention K/V [B,
n_audio_frames, Hkv, hd], projected once from the encoder's output at
prefill.  Decode writes the self K/V in place and reads the cross K/V
whole.  ``train`` mode (`whisper_loss`) runs the encoder over the frames
and the decoder over every position, each decoder block under the same
`torch.utils.checkpoint` as `lm._remat` (the reference checkpoints the
decoder blocks, not the encoder), and builds no cache.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import mlp
from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn


def sinusoidal_pos(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] sin | cos table, computed in numpy float64 and rounded to
    float32 once, as the reference (a float32 `torch.sin` differs in the
    last bits)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out.astype(np.float32), device=device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _enc_block_init(ctx: nn.InitCtx, cfg: ModelConfig, n_layers: int) -> dict:
    d = cfg.d_model
    return {
        "norm1": nn.ones(ctx, (n_layers, d), ("layers", "embed")),
        "attn": attn.attn_init(ctx, cfg, n_layers),
        "norm2": nn.ones(ctx, (n_layers, d), ("layers", "embed")),
        "ffn": mlp.dense_ffn_init(ctx, cfg, cfg.d_ff, n_layers),
    }


def _dec_block_init(ctx: nn.InitCtx, cfg: ModelConfig, n_layers: int) -> dict:
    d = cfg.d_model
    return {
        "norm1": nn.ones(ctx, (n_layers, d), ("layers", "embed")),
        "self_attn": attn.attn_init(ctx, cfg, n_layers),
        "norm_x": nn.ones(ctx, (n_layers, d), ("layers", "embed")),
        "cross_attn": attn.attn_init(ctx, cfg, n_layers, cross=True),
        "norm2": nn.ones(ctx, (n_layers, d), ("layers", "embed")),
        "ffn": mlp.dense_ffn_init(ctx, cfg, cfg.d_ff, n_layers),
    }


def whisper_init(ctx: nn.InitCtx, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "embed": nn.normal(ctx, (cfg.padded_vocab, d), ("vocab", "embed_fsdp")),
        "enc_blocks": _enc_block_init(ctx, cfg, cfg.n_encoder_layers),
        "enc_norm": nn.ones(ctx, (d,), ("embed",)),
        "dec_blocks": _dec_block_init(ctx, cfg, cfg.n_layers),
        "dec_norm": nn.ones(ctx, (d,), ("embed",)),
        "head": nn.fan_in_normal(ctx, (d, cfg.padded_vocab), ("embed_fsdp", "vocab")),
    }


def encode(p: dict, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames [B, F, d] (the stub frontend's output) -> encoder states [B, F,
    d]: the frames and the sinusoidal table each cast to the model dtype and
    added there, then the encoder blocks in a Python loop."""
    dev = p["embed"].device
    dt = cfg.torch_dtype
    frames = torch.as_tensor(frames, device=dev)
    F = frames.shape[1]
    x = frames.to(dt) + sinusoidal_pos(F, cfg.d_model, dev).to(dt)
    positions = torch.arange(F, dtype=torch.int32, device=dev)
    for bp in lm._unstack(p["enc_blocks"], cfg.n_encoder_layers):
        h = nn.rms_norm(x, bp["norm1"], cfg.norm_eps)
        y, _ = attn.attn_apply(bp["attn"], cfg, h, positions, causal=False)
        x, h = lm._add_norm(x, y, bp["norm2"], cfg.norm_eps)
        x = x + mlp.dense_ffn_apply(bp["ffn"], h)
    return nn.rms_norm(x, p["enc_norm"], cfg.norm_eps)


def _dec_block(bp: dict, cfg: ModelConfig, x, positions, enc_out, mode: str, cache, cache_len):
    """One decoder block; returns (x, {"self": (k, v), "cross": (k, v)}).
    In decode the self K/V are written into ``cache["self"]`` in place and
    ``cache["cross"]`` is read whole and returned as it is."""
    h = nn.rms_norm(x, bp["norm1"], cfg.norm_eps)
    if mode == "decode":
        y, self_kv = attn.attn_decode(bp["self_attn"], cfg, h, cache["self"], cache_len)
    else:
        y, self_kv = attn.attn_apply(bp["self_attn"], cfg, h, positions, causal=True)
    x, h = lm._add_norm(x, y, bp["norm_x"], cfg.norm_eps)
    if mode == "decode":
        cross_kv = cache["cross"]
        y, _ = attn.attn_decode(bp["cross_attn"], cfg, h, cross_kv, cross_kv[0].shape[1],
                                cross=True)
    else:
        y, cross_kv = attn.attn_apply(bp["cross_attn"], cfg, h, positions, causal=False,
                                      kv=enc_out)
    x, h = lm._add_norm(x, y, bp["norm2"], cfg.norm_eps)
    x = x + mlp.dense_ffn_apply(bp["ffn"], h)
    return x, {"self": self_kv, "cross": cross_kv}


def whisper_forward(
    p: dict,
    cfg: ModelConfig,
    batch: dict,
    mode: str,
    cache: Optional[dict] = None,
    cache_len=None,
):
    """train: batch = {"frames" [B, F, d], "tokens" [B, S]} -> (logits [B,
    S, V] at every position, aux f32 0: whisper has no MoE); prefill: the
    same batch -> (the last position's logits [B, 1, V], the cache of the
    prompt: self K/V [B, S, ...] and cross K/V [B, F, ...] with a leading
    layer axis); decode: batch = {"tokens" [B, 1]} at position
    ``cache_len`` -> (logits, the cache updated in place)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"whisper_forward: unknown mode {mode!r}")
    embed = p["embed"]
    x = embed[torch.as_tensor(batch["tokens"], device=embed.device).long()]   # [B, S, d]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    enc_out = None if mode == "decode" else encode(p, cfg, batch["frames"])
    n = cfg.n_layers
    layer_cache = None if cache is None else lm._unstack(cache["dec"], n)
    train_block = lm._remat(
        lambda x_, bp: _dec_block(bp, cfg, x_, positions, enc_out, mode, None, None)[0], cfg)
    entries = []
    for g, bp in enumerate(lm._unstack(p["dec_blocks"], n)):
        if mode == "train":
            x = train_block(x, bp)
            continue
        x, kv = _dec_block(bp, cfg, x, positions, enc_out, mode,
                           None if layer_cache is None else layer_cache[g], cache_len)
        entries.append(kv)
    x = nn.rms_norm(x, p["dec_norm"], cfg.norm_eps)
    if mode == "prefill":
        new_cache = {"dec": lm._stack(entries)}
        x = x[:, -1:]                                      # only last-position logits
    else:
        new_cache = cache
    logits = nn.dense(x, p["head"])
    if cfg.logits_f32:
        logits = logits.to(torch.float32)
    if mode == "train":
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, new_cache


def whisper_init_cache(cfg: ModelConfig, batch: int, cap: int, device) -> dict:
    """Zeroed self K/V [n_layers, batch, cap, Hkv, hd] and cross K/V
    [n_layers, batch, n_audio_frames, Hkv, hd] on ``device``."""
    return {"dec": {
        "self": attn.init_cache(cfg, cfg.n_layers, batch, cap, device),
        "cross": attn.init_cache(cfg, cfg.n_layers, batch, cfg.n_audio_frames, device),
    }}


def whisper_cache_axes(cfg: ModelConfig) -> dict:
    names = ("layers",) + attn.CACHE_AXES
    return {"dec": {"self": (names, names), "cross": (names, names)}}


def whisper_loss(p: dict, cfg: ModelConfig, batch: dict):
    """(CE, {"ce", "n_tokens"}) over ``batch`` = {"frames", "tokens",
    "labels" (-100 ignored)}; no aux term, as the reference."""
    logits, _ = whisper_forward(p, cfg, batch, mode="train")
    ce, n = nn.softmax_cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "n_tokens": n}
