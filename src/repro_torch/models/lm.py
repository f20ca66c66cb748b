"""Decoder LM, twin of `repro.models.lm`, for the dense GQA family.

Parameters are the reference's tree: ``embed`` [padded_vocab, d],
``final_norm``, ``head`` [d, padded_vocab] (unless tied) and ``groups``,
one entry per position of ``cfg.block_pattern`` whose tensors carry a
leading layer axis (the reference's stacked scan groups).  `lm_forward`
walks that axis in a Python loop instead of a scan.

The cache is ``{"groups": {"l0": (k, v)}}`` with k/v [n_layers, B, cap,
Hkv, hd]; decode updates it in place and returns the same tree.

Ported: ``"attn"`` blocks with dense FFNs.  Mamba, mLSTM and sLSTM blocks,
prelude (``first_k_dense``) layers, MoE FFNs, vision tokens and the
encoder-decoder raise `NotImplementedError` (`ROADMAP.md` queue 1, item 11).
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
    elif cfg.first_k_dense:
        why = "prelude (first_k_dense) layers"
    elif cfg.n_vision_tokens:
        why = "vision tokens"
    elif any(kind != "attn" for kind in cfg.layer_kinds()):
        why = f"block kinds {sorted(set(cfg.layer_kinds()) - {'attn'})}"
    elif any(cfg.layer_is_moe(i) for i in range(cfg.n_layers)):
        why = "MoE FFNs"
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
    leading axis (the reference's vmapped `stack_init`)."""
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
    nG = _n_groups(cfg)
    p["groups"] = {
        f"l{j}": block_init(ctx, cfg, j, nG) for j in range(len(cfg.block_pattern))
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
    ``prefill`` (with the prompt's [n_layers, B, S, Hkv, hd] cache), the new
    token's in ``decode`` (the cache updated in place at ``cache_len``).
    Training, the reference's third mode, is not ported yet."""
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
        new_cache = {"groups": {name: (torch.stack(ks), torch.stack(vs))
                                for name, (ks, vs) in prefill_kv.items()}}
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

def lm_init_cache(cfg: ModelConfig, batch: int, cap: int, device) -> dict:
    nG = _n_groups(cfg)
    return {"groups": {f"l{j}": attn.init_cache(cfg, nG, batch, cap, device)
                       for j in range(len(cfg.block_pattern))}}


def lm_cache_axes(cfg: ModelConfig) -> dict:
    axes = ("layers",) + attn.CACHE_AXES
    return {"groups": {f"l{j}": (axes, axes) for j in range(len(cfg.block_pattern))}}
