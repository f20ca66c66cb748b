"""Decoder LM, twin of `repro.models.lm`: attention decoders with dense or
MoE FFNs, Mamba-2 hybrids (Jamba) and xLSTM stacks.

Parameters are the reference's tree: ``embed`` [padded_vocab, d],
``final_norm``, ``head`` [d, padded_vocab] (unless tied), one unstacked
block ``prelude_{i}`` for each of the ``first_k_dense`` leading layers
(DeepSeek-MoE's dense layer 0), and ``groups``, one entry per position of
``cfg.block_pattern`` whose tensors carry a leading layer axis (the
reference's stacked scan groups).  A block holds ``norm1`` and its mixer
(``attn``, ``mamba``, ``mlstm`` or ``slstm``); attention and Mamba blocks
add ``norm2`` and an FFN (dense or MoE by `ModelConfig.layer_is_moe`),
mLSTM and sLSTM blocks carry their own projections and have neither.
`lm_forward` runs the prelude blocks, then walks the groups' layer axis in
a Python loop instead of a scan.

The cache has the same layout: ``{"prelude_{i}": entry, "groups": {"l0":
entry, ...}}``, an entry being an attention layer's (k, v) [B, cap, Hkv,
hd] or a recurrent block's state dict (`mamba.init_mamba_state`,
`xlstm.init_mlstm_state`, `xlstm.init_slstm_state`), with a leading
[n_layers] axis in the groups.  Decode updates every entry in place and
returns the same tree.

Vision tokens and the encoder-decoder raise `NotImplementedError`
(`ROADMAP.md` queue 1, item 11 (c)).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import mlp
from repro_torch.models import xlstm as xl
from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn


def check_supported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for what the port does not serve yet:
    the encoder-decoder and vision tokens."""
    why = None
    if cfg.is_encoder_decoder:
        why = "the encoder-decoder"
    elif cfg.n_vision_tokens:
        why = "vision tokens"
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


def _stack(trees: list):
    """n trees of per-layer tensors -> one tree of [n, ...] tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


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
# One block (mixer + FFN)
# ---------------------------------------------------------------------------

class _Mixer(NamedTuple):
    """A recurrent block kind's functions and its state's axes."""
    init: Callable
    apply: Callable          # full sequence, (y, state)
    decode: Callable         # one token, (y, new state)
    init_state: Callable
    state_axes: dict


_RECURRENT = {
    "mamba": _Mixer(mb.mamba_init, mb.mamba_apply, mb.mamba_decode, mb.init_mamba_state,
                    mb.MAMBA_STATE_AXES),
    "mlstm": _Mixer(xl.mlstm_init, xl.mlstm_apply, xl.mlstm_decode, xl.init_mlstm_state,
                    xl.MLSTM_STATE_AXES),
    "slstm": _Mixer(xl.slstm_init, xl.slstm_apply, xl.slstm_decode, xl.init_slstm_state,
                    xl.SLSTM_STATE_AXES),
}


def _has_ffn(kind: str) -> bool:
    """Attention and Mamba blocks carry norm2 and an FFN; xLSTM blocks not."""
    return kind in ("attn", "mamba")


def _kind(cfg: ModelConfig, layer_idx: int) -> str:
    kind = cfg.layer_kinds()[layer_idx]
    if kind != "attn" and kind not in _RECURRENT:
        raise ValueError(f"unknown block kind {kind!r}")
    return kind


def block_init(ctx: nn.InitCtx, cfg: ModelConfig, layer_idx: int, n_layers: int) -> dict:
    """``n_layers`` blocks like layer ``layer_idx``, stacked on a leading
    axis (the reference's vmapped `stack_init`); one prelude block is
    ``_unstack(block_init(..., 1), 1)[0]``."""
    kind = _kind(cfg, layer_idx)
    p = {"norm1": nn.ones(ctx, (n_layers, cfg.d_model))}
    if kind == "attn":
        p["attn"] = attn.attn_init(ctx, cfg, n_layers)
    else:
        p[kind] = _RECURRENT[kind].init(ctx, cfg, n_layers)
    if _has_ffn(kind):
        p["norm2"] = nn.ones(ctx, (n_layers, cfg.d_model))
        p["ffn"] = mlp.ffn_init(ctx, cfg, layer_idx, n_layers)
    return p


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
    """Returns (x, new_cache).  In decode a recurrent block's new state is
    written into ``cache`` in place (as attention writes its K/V), and
    ``cache`` is returned.  A recurrent mixer runs under the profiler label
    ``netmcp.<kind>``."""
    h = nn.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        if mode == "decode":
            y, new_cache = attn.attn_decode(p["attn"], cfg, h, cache, cache_len)
        else:
            y, new_cache = attn.attn_apply(p["attn"], cfg, h, positions)
    else:
        mixer = _RECURRENT[kind]
        with torch.profiler.record_function(f"netmcp.{kind}"):
            if mode == "decode":
                y, state = mixer.decode(p[kind], cfg, h, cache)
                for name, t in state.items():
                    cache[name].copy_(t)
                new_cache = cache
            else:
                y, new_cache = mixer.apply(p[kind], cfg, h, return_state=True)
    if not _has_ffn(kind):
        return x + y, new_cache
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
    ``prefill`` (with the prompt's cache: an attention layer's k/v [B, S,
    Hkv, hd], a recurrent block's state after the prompt, each with a
    leading [n_layers] axis in the groups), the new token's in ``decode``
    (the cache updated in place: K/V at ``cache_len``, the states whole).
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
    prelude_kv = {}
    for i in range(cfg.first_k_dense):
        name = f"prelude_{i}"
        x, c_new = block_apply(p[name], cfg, cfg.layer_kinds()[i], x, positions, mode,
                               None if cache is None else cache[name], cache_len)
        prelude_kv[name] = c_new
    nG = _n_groups(cfg)
    layers = _unstack(p["groups"], nG)
    layer_cache = None if cache is None else _unstack(cache["groups"], nG)
    prefill_cache = {f"l{j}": [] for j in range(len(kinds))}
    for g in range(nG):
        for j, kind in enumerate(kinds):
            entry = None if layer_cache is None else layer_cache[g][f"l{j}"]
            x, c_new = block_apply(layers[g][f"l{j}"], cfg, kind, x, positions, mode, entry,
                                   cache_len)
            if mode == "prefill":
                prefill_cache[f"l{j}"].append(c_new)

    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        new_cache = dict(prelude_kv)
        new_cache["groups"] = {name: _stack(entries) for name, entries in prefill_cache.items()}
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

def block_cache(cfg: ModelConfig, layer_idx: int, batch: int, cap: int, device,
                n_layers: Optional[int] = None):
    """The empty cache of layer ``layer_idx``'s kind for ``batch`` sequences:
    (k, v) [batch, cap, Hkv, hd] of an attention layer, a recurrent block's
    state dict; with ``n_layers``, stacked on a leading layer axis."""
    kind = _kind(cfg, layer_idx)
    if kind == "attn":
        kv = attn.init_cache(cfg, n_layers or 1, batch, cap, device)
        return kv if n_layers is not None else tuple(t[0] for t in kv)
    return _RECURRENT[kind].init_state(cfg, batch, device, n_layers)


def block_cache_axes(cfg: ModelConfig, layer_idx: int):
    kind = _kind(cfg, layer_idx)
    if kind == "attn":
        return (attn.CACHE_AXES, attn.CACHE_AXES)
    return _RECURRENT[kind].state_axes


def _layer_axes(axes):
    """Prefix every axes tuple of a block's axes tree with "layers"."""
    if isinstance(axes, dict):
        return {k: _layer_axes(v) for k, v in axes.items()}
    if all(isinstance(a, str) for a in axes):
        return ("layers",) + tuple(axes)
    return tuple(_layer_axes(a) for a in axes)


def lm_init_cache(cfg: ModelConfig, batch: int, cap: int, device) -> dict:
    cache: dict = {f"prelude_{i}": block_cache(cfg, i, batch, cap, device)
                   for i in range(cfg.first_k_dense)}
    nG = _n_groups(cfg)
    cache["groups"] = {f"l{j}": block_cache(cfg, cfg.first_k_dense + j, batch, cap, device, nG)
                       for j in range(len(cfg.block_pattern))}
    return cache


def lm_cache_axes(cfg: ModelConfig) -> dict:
    axes: dict = {f"prelude_{i}": block_cache_axes(cfg, i) for i in range(cfg.first_k_dense)}
    axes["groups"] = {f"l{j}": _layer_axes(block_cache_axes(cfg, cfg.first_k_dense + j))
                      for j in range(len(cfg.block_pattern))}
    return axes
