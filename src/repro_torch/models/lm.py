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
a Python loop instead of a scan.  In ``train`` mode (`lm_loss`) each layer
group runs under `torch.utils.checkpoint` as the reference's `_remat`
says (``cfg.remat``), and autograd gives the backward.

The cache has the same layout: ``{"prelude_{i}": entry, "groups": {"l0":
entry, ...}}``, an entry being an attention layer's (k, v) [B, cap, Hkv,
hd] or a recurrent block's state dict (`mamba.init_mamba_state`,
`xlstm.init_mlstm_state`, `xlstm.init_slstm_state`), with a leading
[n_layers] axis in the groups.  Decode updates every entry in place and
returns the same tree.

A VLM config (``n_vision_tokens``) adds ``vision_proj`` [d, d]: its
prefill takes ``patches`` [B, V, d] (the stubbed vision frontend's
output), cast to the model dtype, projected and put before the token
embeddings, so the cache holds V + S positions; decode takes tokens only.
The encoder-decoder is `repro_torch.models.whisper`.
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
    """A tree of [n, ...] tensors -> n trees of per-layer views (an axes
    tree's names lose their leading "layers")."""
    if nn.is_axes(tree):
        return [tree[1:]] * n
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
    p = {"norm1": nn.ones(ctx, (n_layers, cfg.d_model), ("layers", "embed"))}
    if kind == "attn":
        p["attn"] = attn.attn_init(ctx, cfg, n_layers)
    else:
        p[kind] = _RECURRENT[kind].init(ctx, cfg, n_layers)
    if _has_ffn(kind):
        p["norm2"] = nn.ones(ctx, (n_layers, cfg.d_model), ("layers", "embed"))
        p["ffn"] = mlp.ffn_init(ctx, cfg, layer_idx, n_layers)
    return p


def _add_norm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, eps: float):
    """(x + y, rms_norm(x + y)).  The norm reads the residual sum before it
    is rounded to the model dtype, as the reference's compiled block does
    (XLA keeps the bf16 add in f32 where it feeds the norm's f32 convert);
    the carried residual is rounded.  In f32 the two are the same."""
    h = nn.rms_norm(x.to(torch.float32) + y.to(torch.float32), scale, eps).to(x.dtype)
    return x + y, h


def block_apply(
    p: dict,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,                        # train | prefill | decode
    cache=None,
    cache_len=None,
):
    """Returns (x, new_cache, aux): aux is the FFN's load-balancing loss
    (0.0 without a MoE FFN).  ``train`` runs the prefill path and keeps
    no cache (None).  In decode a recurrent block's new state is written
    into ``cache`` in place (as attention writes its K/V), and ``cache`` is
    returned.  A recurrent mixer runs under the profiler label
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
                y, new_cache = mixer.apply(p[kind], cfg, h, return_state=mode == "prefill")
    if mode == "train":
        new_cache = None
    if not _has_ffn(kind):
        return x + y, new_cache, 0.0
    x, h2 = _add_norm(x, y, p["norm2"], cfg.norm_eps)
    y2, aux = mlp.ffn_apply(p["ffn"], cfg, h2)
    return x + y2, new_cache, aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def lm_init(ctx: nn.InitCtx, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    p: dict = {
        "embed": nn.normal(ctx, (cfg.padded_vocab, d), ("vocab", "embed_fsdp")),
        "final_norm": nn.ones(ctx, (d,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        p["head"] = nn.fan_in_normal(ctx, (d, cfg.padded_vocab), ("embed_fsdp", "vocab"))
    if cfg.n_vision_tokens:
        p["vision_proj"] = nn.fan_in_normal(ctx, (d, d), ("embed_fsdp", "embed"))
    for i in range(cfg.first_k_dense):
        p[f"prelude_{i}"] = _unstack(block_init(ctx, cfg, i, 1), 1)[0]
    nG = _n_groups(cfg)
    p["groups"] = {
        f"l{j}": block_init(ctx, cfg, cfg.first_k_dense + j, nG)
        for j in range(len(cfg.block_pattern))
    }
    return p


def _embed_tokens(p: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings [B, S, d]; a VLM's projected ``patches`` [B, V, d]
    (cast to the model dtype first, as the reference) go before them."""
    embed = p["embed"]
    x = embed[torch.as_tensor(batch["tokens"], device=embed.device).long()]
    if cfg.n_vision_tokens:
        patches = torch.as_tensor(batch["patches"], device=embed.device).to(x.dtype)
        x = torch.cat([nn.dense(patches, p["vision_proj"]), x], dim=1)
    return x


def _matmul_outputs_saved(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    plain 2-D matrix products (the projections, `aten.mm`), recompute the
    rest, batched products (the attention scores) included: the
    reference's `dots_with_no_batch_dims_saveable`."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under `torch.utils.checkpoint` (non-reentrant) when autograd
    records, as the reference's `_remat` wraps a layer group in
    `jax.checkpoint`: ``remat="full"`` keeps only the group's input and
    recomputes the group in the backward; ``"dots"`` also keeps its
    projections' outputs (`_matmul_outputs_saved`, PyTorch's selective
    checkpointing); ``"none"`` keeps every activation.  Values do not
    change, only memory."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        extra = {}
        if cfg.remat == "dots":
            extra["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _matmul_outputs_saved)
        return checkpoint(fn, *args, use_reentrant=False, **extra)

    return wrapped


def lm_forward(
    p: dict,
    cfg: ModelConfig,
    batch: dict,
    mode: str,
    cache: Optional[dict] = None,
    cache_len=None,
):
    """``train``: (logits [B, V + S, vocab] at every position, aux: the
    load-balancing losses summed over the prelude and every group, f32),
    no cache built, each layer group under `_remat`.  ``prefill``: (the
    last position's logits, the prompt's cache: an attention layer's k/v
    [B, S, Hkv, hd], a recurrent block's state after the prompt, each with
    a leading [n_layers] axis in the groups; S counts a VLM's patches).
    ``decode``: (the new token's logits, the cache updated in place: K/V
    at ``cache_len``, the states whole)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"lm_forward: unknown mode {mode!r}")
    embed = p["embed"]
    if mode == "decode":
        x = embed[torch.as_tensor(batch["tokens"], device=embed.device).long()]   # [B, 1, d]
    else:
        x = _embed_tokens(p, cfg, batch)                   # [B, V + S, d]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    kinds = list(cfg.block_pattern)
    auxes = []
    prelude_kv = {}
    for i in range(cfg.first_k_dense):
        name = f"prelude_{i}"
        x, prelude_kv[name], aux = block_apply(p[name], cfg, cfg.layer_kinds()[i], x,
                                               positions, mode,
                                               None if cache is None else cache[name],
                                               cache_len)
        auxes.append(aux)

    def group(x, gp, gc):
        """One repetition of the block pattern: (x, its blocks' new cache
        entries, their summed aux)."""
        aux_g = 0.0
        entries = {}
        for j, kind in enumerate(kinds):
            x, entries[f"l{j}"], aux = block_apply(
                gp[f"l{j}"], cfg, kind, x, positions, mode,
                None if gc is None else gc[f"l{j}"], cache_len)
            if mode == "train":
                aux_g = aux_g + aux
        return x, entries, aux_g

    nG = _n_groups(cfg)
    layers = _unstack(p["groups"], nG)
    layer_cache = None if cache is None else _unstack(cache["groups"], nG)
    prefill_cache = {f"l{j}": [] for j in range(len(kinds))}
    run_group = _remat(group, cfg) if mode == "train" else group
    for g in range(nG):
        x, entries, aux_g = run_group(x, layers[g],
                                      None if layer_cache is None else layer_cache[g])
        auxes.append(aux_g)
        if mode == "prefill":
            for name, c_new in entries.items():
                prefill_cache[name].append(c_new)

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
    if mode == "train":
        return logits, sum(auxes, torch.zeros((), dtype=torch.float32, device=x.device))
    return logits, new_cache


def lm_loss(p: dict, cfg: ModelConfig, batch: dict):
    """(CE + aux, {"ce", "aux", "n_tokens"}) over ``batch`` = {"tokens" [B,
    S], "labels" [B, S] (-100 ignored)}; a VLM's batch adds "patches" [B,
    V, d], whose positions get label -100."""
    logits, aux = lm_forward(p, cfg, batch, mode="train")
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if cfg.n_vision_tokens:
        ignore = torch.full((labels.shape[0], cfg.n_vision_tokens), -100, dtype=labels.dtype,
                            device=labels.device)
        labels = torch.cat([ignore, labels], dim=1)
    ce, n = nn.softmax_cross_entropy(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux, "n_tokens": n}


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
