"""Decoder LM, twin of `repro.models.lm`, for attention decoders with
dense or MoE FFNs.

Parameters are the reference's tree: ``embed`` [padded_vocab, d],
``final_norm``, ``head`` [d, padded_vocab] (unless tied), one unstacked
block ``prelude_{i}`` for each of the ``first_k_dense`` leading layers
(DeepSeek-MoE's dense layer 0), and ``groups``, one entry per position of
``cfg.block_pattern`` whose tensors carry a leading layer axis (the
reference's stacked scan groups).  `lm_forward` runs the prelude blocks,
then walks the groups' layer axis in a Python loop instead of a scan.

The cache is ``{"prelude_{i}": (k, v), "groups": {"l0": (k, v)}}``: k/v
[B, cap, Hkv, hd] for a prelude layer, [n_layers, B, cap, Hkv, hd] in the
groups; decode updates it in place and returns the same tree.

Ported: ``"attn"`` blocks with dense or MoE FFNs, prelude layers included.
Mamba, mLSTM and sLSTM blocks, vision tokens and the encoder-decoder raise
`NotImplementedError` (`ROADMAP.md` queue 1, item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp
from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn


def check_supported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for what the port does not serve yet."""
    why = None
    if cfg.is_encoder_decoder:
        why = "the encoder-decoder"
    elif cfg.n_vision_tokens:
        why = "vision tokens"
    elif any(kind != "attn" for kind in cfg.layer_kinds()):
        why = f"block kinds {sorted(set(cfg.layer_kinds()) - {'attn'})}"
    if why is not None:
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs {why}, which is not ported yet "
            "(ROADMAP.md queue 1, item 11)"
        )


def _n_groups(cfg: ModelConfig) -> int:
    rem = cfg.n_layers - cfg.first_k_dense
    if rem % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: {rem} layers do not tile the block pattern")
    return rem // len(cfg.block_pattern)


def _unstack(tree, n: int) -> list:
    """A tree of [n, ...] tensors -> n trees of per-layer views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_unstack(v, n) for v in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# One block (attention + FFN)
# ---------------------------------------------------------------------------

def block_init(ctx: nn.InitCtx, cfg: ModelConfig, layer_idx: int, n_layers: int) -> dict:
    """``n_layers`` ``"attn"`` blocks like layer ``layer_idx``, stacked on a
    leading axis (the reference's vmapped `stack_init`); one prelude block
    is ``_unstack(block_init(..., 1), 1)[0]``."""
    kind = cfg.layer_kinds()[layer_idx]
    if kind != "attn":
        raise NotImplementedError(f"repro_torch: {kind} blocks are not ported yet")
    return {
        "norm1": nn.ones(ctx, (n_layers, cfg.d_model)),
        "attn": attn.attn_init(ctx, cfg, n_layers),
        "norm2": nn.ones(ctx, (n_layers, cfg.d_model)),
        "ffn": mlp.ffn_init(ctx, cfg, layer_idx, n_layers),
    }


def block_apply(
    p: dict,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,                        # prefill | decode
    cache=None,
    cache_len=None,
):
    """Returns (x, new_cache)."""
    if kind != "attn":
        raise NotImplementedError(f"repro_torch: {kind} blocks are not ported yet")
    h = nn.rms_norm(x, p["norm1"], cfg.norm_eps)
    if mode == "decode":
        y, new_cache = attn.attn_decode(p["attn"], cfg, h, cache, cache_len)
    else:
        y, new_cache = attn.attn_apply(p["attn"], cfg, h, positions)
    # The second norm reads the residual sum before it is rounded to the
    # model dtype, as the reference's compiled block does (XLA keeps the
    # bf16 add in f32 where it feeds the norm's f32 convert); the carried
    # residual is rounded.  In f32 the two are the same.
    h2 = nn.rms_norm(x.to(torch.float32) + y.to(torch.float32), p["norm2"],
                     cfg.norm_eps).to(x.dtype)
    x = x + y
    return x + mlp.ffn_apply(p["ffn"], cfg, h2), new_cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def lm_init(ctx: nn.InitCtx, cfg: ModelConfig) -> dict:
    check_supported(cfg)
    d = cfg.d_model
    p: dict = {
        "embed": nn.normal(ctx, (cfg.padded_vocab, d)),
        "final_norm": nn.ones(ctx, (d,)),
    }
    if not cfg.tie_embeddings:
        p["head"] = nn.fan_in_normal(ctx, (d, cfg.padded_vocab))
    for i in range(cfg.first_k_dense):
        p[f"prelude_{i}"] = _unstack(block_init(ctx, cfg, i, 1), 1)[0]
    nG = _n_groups(cfg)
    p["groups"] = {
        f"l{j}": block_init(ctx, cfg, cfg.first_k_dense + j, nG)
        for j in range(len(cfg.block_pattern))
    }
    return p


def lm_forward(
    p: dict,
    cfg: ModelConfig,
    batch: dict,
    mode: str,
    cache: Optional[dict] = None,
    cache_len=None,
):
    """Returns (logits, new_cache): the last position's logits in
    ``prefill`` (with the prompt's cache, [B, S, Hkv, hd] per prelude layer
    and [n_layers, B, S, Hkv, hd] per group entry), the new token's in
    ``decode`` (the cache updated in place at ``cache_len``).  Training, the
    reference's third mode, is not ported yet."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"lm_forward: unknown mode {mode!r}")
    if set(batch) - {"tokens"}:
        raise NotImplementedError(f"repro_torch: batch inputs {sorted(set(batch) - {'tokens'})} "
                                  "(vision / audio) are not ported yet")
    embed = p["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=embed.device).long()
    x = embed[tokens]                                      # [B, S, d]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    kinds = list(cfg.block_pattern)
    prelude_kv = {}
    for i in range(cfg.first_k_dense):
        name = f"prelude_{i}"
        x, c_new = block_apply(p[name], cfg, cfg.layer_kinds()[i], x, positions, mode,
                               None if cache is None else cache[name], cache_len)
        prelude_kv[name] = c_new
    nG = _n_groups(cfg)
    layers = _unstack(p["groups"], nG)
    layer_cache = None if cache is None else _unstack(cache["groups"], nG)
    prefill_kv = {f"l{j}": ([], []) for j in range(len(kinds))}
    for g in range(nG):
        for j, kind in enumerate(kinds):
            entry = None if layer_cache is None else layer_cache[g][f"l{j}"]
            x, c_new = block_apply(layers[g][f"l{j}"], cfg, kind, x, positions, mode, entry,
                                   cache_len)
            if mode == "prefill":
                prefill_kv[f"l{j}"][0].append(c_new[0])
                prefill_kv[f"l{j}"][1].append(c_new[1])

    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        new_cache = dict(prelude_kv)
        new_cache["groups"] = {name: (torch.stack(ks), torch.stack(vs))
                               for name, (ks, vs) in prefill_kv.items()}
        x = x[:, -1:]                                      # only last-position logits
    else:
        new_cache = cache
    head = embed.T if cfg.tie_embeddings else p["head"]
    logits = nn.dense(x, head)
    if cfg.logits_f32:
        logits = logits.to(torch.float32)
    return logits, new_cache


# ---------------------------------------------------------------------------
# Cache init (tree matches lm_forward's cache layout)
# ---------------------------------------------------------------------------

def block_cache(cfg: ModelConfig, layer_idx: int, batch: int, cap: int, device) -> tuple:
    """Zeroed (k, v) [batch, cap, Hkv, hd] of one ``"attn"`` layer."""
    kind = cfg.layer_kinds()[layer_idx]
    if kind != "attn":
        raise NotImplementedError(f"repro_torch: {kind} blocks are not ported yet")
    return tuple(t[0] for t in attn.init_cache(cfg, 1, batch, cap, device))


def block_cache_axes(cfg: ModelConfig, layer_idx: int) -> tuple:
    kind = cfg.layer_kinds()[layer_idx]
    if kind != "attn":
        raise NotImplementedError(f"repro_torch: {kind} blocks are not ported yet")
    return (attn.CACHE_AXES, attn.CACHE_AXES)


def lm_init_cache(cfg: ModelConfig, batch: int, cap: int, device) -> dict:
    cache: dict = {f"prelude_{i}": block_cache(cfg, i, batch, cap, device)
                   for i in range(cfg.first_k_dense)}
    nG = _n_groups(cfg)
    cache["groups"] = {f"l{j}": attn.init_cache(cfg, nG, batch, cap, device)
                       for j in range(len(cfg.block_pattern))}
    return cache


def lm_cache_axes(cfg: ModelConfig) -> dict:
    axes: dict = {f"prelude_{i}": block_cache_axes(cfg, i) for i in range(cfg.first_k_dense)}
    axes["groups"] = {
        f"l{j}": tuple(("layers",) + names
                       for names in block_cache_axes(cfg, cfg.first_k_dense + j))
        for j in range(len(cfg.block_pattern))
    }
    return axes
