"""FFN layers, twin of `repro.models.mlp`: the dense SwiGLU and the
sort-based capacity MoE.

Every weight carries the port's leading layer axis (the reference's stacked
scan groups): a dense FFN is ``w_gate`` [n_layers, d, f], a MoE FFN
``router`` [n_layers, d, E] and experts [n_layers, E, d, f]; `lm_forward`
hands each layer its own slice.

MoE dispatch is the reference's static-shape formulation: each batch row's
(token, expert) assignments are sorted by expert id (stable, so the earlier
entries of an expert win its capacity), truncated to a per-expert capacity
C = `_capacity(S, K, E, capacity_factor)` per row, and run through one
grouped [E, B*C, d] x [E, d, f] product (`torch.bmm`, as the reference's
einsums).  The rows are sorted in one batched call along the row's own axis,
so a row's capacity and drops are its own: a decode slot cannot take
another's.  Shared experts (DeepSeek-MoE) are one dense SwiGLU of hidden
``n_shared_experts * moe_d_ff``, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.nn import core as nn


# ---------------------------------------------------------------------------
# Dense SwiGLU
# ---------------------------------------------------------------------------

def dense_ffn_init(ctx: nn.InitCtx, cfg: ModelConfig, hidden: int, n_layers: int) -> dict:
    """SwiGLU weights of ``n_layers`` layers, stacked on a leading axis."""
    d, n = cfg.d_model, n_layers
    return {
        "w_gate": nn.fan_in_normal(ctx, (n, d, hidden), ("layers", "embed_fsdp", "mlp"), fan_in=d),
        "w_up": nn.fan_in_normal(ctx, (n, d, hidden), ("layers", "embed_fsdp", "mlp"), fan_in=d),
        "w_down": nn.fan_in_normal(ctx, (n, hidden, d), ("layers", "mlp", "embed_fsdp"),
                                   fan_in=hidden),
    }


def dense_ffn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return nn.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_ffn_init(ctx: nn.InitCtx, cfg: ModelConfig, n_layers: int) -> dict:
    """Router [n, d, E] (std 0.02), experts [n, E, d, f] / [n, E, f, d]
    (fan-in normals) and, with shared experts, one dense SwiGLU of hidden
    ``n_shared_experts * moe_d_ff``."""
    d, f, E, n = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, n_layers
    p = {
        "router": nn.normal(ctx, (n, d, E), ("layers", "embed_fsdp", "experts"), stddev=0.02),
        "w_gate": nn.fan_in_normal(ctx, (n, E, d, f),
                                   ("layers", "experts", "embed_fsdp", "expert_mlp"), fan_in=d),
        "w_up": nn.fan_in_normal(ctx, (n, E, d, f),
                                 ("layers", "experts", "embed_fsdp", "expert_mlp"), fan_in=d),
        "w_down": nn.fan_in_normal(ctx, (n, E, f, d),
                                   ("layers", "experts", "expert_mlp", "embed_fsdp"), fan_in=f),
    }
    if cfg.n_shared_experts:
        p["shared"] = dense_ffn_init(ctx, cfg, cfg.n_shared_experts * cfg.moe_d_ff, n)
    return p


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    c = int(math.ceil(T * k * factor / E))
    return max(8, int(math.ceil(c / 8) * 8))


def _route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B, T, d] -> (probs [B, T, E] f32, gate_w [B, T, K] f32, sel [B, T, K]).

    The router product is in the model dtype, then f32 (the reference's
    ``nn.dense(...).astype(f32)``)."""
    return _gates(nn.dense(x, p["router"]).to(torch.float32), cfg.experts_per_token)


def _gates(logits: torch.Tensor, K: int):
    """Router logits [..., E] f32 -> (probs, gate_w, sel): the top-k of the
    softmax probabilities with ties to the lower expert index
    (`jax.lax.top_k`'s order), through a stable descending sort, and their
    weights renormalised to sum to 1."""
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, sel = top[..., :K], idx[..., :K]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_w, sel


def _moe_dispatch(p: dict, cfg: ModelConfig, x: torch.Tensor, C: int):
    """Routing and sort-based dispatch of every row of x [B, T, d] ->
    (buf [B, E, C, d], slot [B, T*K], token_of [B, T*K], w_keep [B, T*K],
    aux [B]); row b is the reference's `_moe_dispatch` of x[b].

    Entries are in each row's sorted order.  A dropped entry (past its
    expert's capacity) keeps ``slot`` at position 0 of its expert and weight
    0, as in the reference.  ``buf`` is filled by a gather from the sorted
    entries (slot (e, c) holds the row's entry ``seg_start[e] + c``), so no
    index is written twice."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    dev = x.device
    probs, gate_w, sel = _route(p, cfg, x)

    # -- load-balancing aux (Switch-style), per row --
    frac_tokens = F.one_hot(sel, E).to(torch.float32).sum(-2).mean(-2) / K   # [B, E]
    frac_probs = probs.mean(-2)
    aux = E * (frac_tokens * frac_probs).sum(-1) * cfg.router_aux_weight

    # -- sort-based dispatch, each row along its own axis --
    TK = T * K
    flat_e = sel.reshape(B, TK)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    token_of = order // K
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, side="left")             # [B, E]
    pos_in_seg = torch.arange(TK, device=dev) - torch.gather(seg_start, 1, sorted_e)
    keep = pos_in_seg < C
    slot = sorted_e * C + torch.where(keep, pos_in_seg, 0)

    seg_end = torch.cat([seg_start[:, 1:], torch.full((B, 1), TK, device=dev)], dim=1)
    src = seg_start[:, :, None] + torch.arange(C, device=dev)                   # [B, E, C]
    filled = src < seg_end[:, :, None]
    tok = torch.gather(token_of, 1, src.clamp(max=TK - 1).reshape(B, E * C))
    rows = torch.gather(x, 1, tok[..., None].expand(B, E * C, d)).reshape(B, E, C, d)
    buf = torch.where(filled[..., None], rows, torch.zeros((), dtype=x.dtype, device=dev))
    w_keep = (torch.gather(gate_w.reshape(B, TK), 1, order) * keep).to(x.dtype)
    return buf, slot, token_of, w_keep, aux


def moe_ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B, S, d] -> (y [B, S, d], aux_loss scalar f32).

    The reference runs the expert FFN in capacity chunks under
    `jax.checkpoint` to bound its training memory; the chunks are
    independent rows, so the port runs all of C in one product per weight
    (in training, the layer group's checkpoint bounds what is kept).  The combine adds each token's K
    contributions ``yb[slot] * w_keep`` in the model dtype, in the row's
    sorted order (the order of the reference's scatter-add), through
    gathers: no atomics, so a result is the same from run to run.  The
    expert products run under the profiler label ``netmcp.experts``."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = _capacity(S, K, E, cfg.capacity_factor)
    buf, slot, token_of, w_keep, aux = _moe_dispatch(p, cfg, x, C)

    with torch.profiler.record_function("netmcp.experts"):
        xe = buf.transpose(0, 1).reshape(E, B * C, d)
        h = nn.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
        yb = torch.bmm(h, p["w_down"]).reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)

    # each token's K entries, at their positions in the sorted order, in
    # that order (a stable sort by token keeps it)
    pos = torch.sort(token_of, dim=-1, stable=True).indices.reshape(B, S, K)
    y = torch.zeros((B, S, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        at = pos[..., k]                                                      # [B, S]
        s = torch.gather(slot, 1, at)
        w = torch.gather(w_keep, 1, at)
        y = y + torch.gather(yb, 1, s[..., None].expand(B, S, d)) * w[..., None]
    if "shared" in p:
        y = y + dense_ffn_apply(p["shared"], x)
    return y, aux.mean()


def ffn_init(ctx: nn.InitCtx, cfg: ModelConfig, layer_idx: int, n_layers: int) -> dict:
    if cfg.layer_is_moe(layer_idx):
        return {"moe": moe_ffn_init(ctx, cfg, n_layers)}
    return {"dense": dense_ffn_init(ctx, cfg, cfg.ffn_hidden(layer_idx), n_layers)}


def ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """(the layer's FFN output, its load-balancing aux loss), as the
    reference: the MoE's f32 scalar, or 0.0 for a dense FFN (a Python
    float, so serving pays no device op for it)."""
    if "moe" in p:
        return moe_ffn_apply(p["moe"], cfg, x)
    return dense_ffn_apply(p["dense"], x), 0.0
