"""Plain PyTorch versions of the kernels, port of `repro.kernels.ref`.

`fused_select_ref` is the unfused stage-2 tail (top-k, softmax, fusion,
argmax) over materialised score matrices: the oracle of the batched
engine's ``use_kernels=False`` path.  `fused_score_select_ref` adds the
stage-2 BM25 product and the candidate mask in front of it: the plain
version of the fused CUDA kernel (`kernels/score_fuse.py`), which the
wrapper in `kernels/ops.py` runs for CPU tensors.  `stage1_topk_ref` is
the sharded engine's stage 1 (template gather, dead and pad masks, a
stable top-k per shard): the plain version of `kernels/stage1_topk.py`.

The softmax denominator is summed over the k slots in order, as the
kernel does, and every top-k is a stable sort, so ties break toward the
lower tool id as ``lax.top_k`` does.

`mha_ref` and `decode_ref` are the plain versions of the attention
kernels (`csrc/flash_attention.cu`, `csrc/decode_attention.cu`): full f32
softmax attention with GQA by repeated K/V, as the reference's oracles.
`decode_split_ref` is the split-KV algebra of the decode kernel (partial
softmax states per split, merged in split order), and `bf16_hi_lo` the
split of f32 probabilities into two bf16 terms that the bf16 flash kernel
feeds its tensor-core PV product.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bm25 import bm25_scores, topk
from repro_torch.core.bm25 import bm25_scores as bm25_ref  # noqa: F401
from repro_torch.core.qos import QosParams, network_score as qos_ref  # noqa: F401

NEG = -1e30   # finite -inf stand-in (kernel and oracle agree)
PAD_NEG = 2.0 * NEG   # shard pad sentinel: sorts strictly below every real score and NEG


def _gather(per_tool: torch.Tensor, top_i: torch.Tensor) -> torch.Tensor:
    per_tool = per_tool.to(torch.float32)
    if per_tool.ndim == 1:
        return per_tool[top_i]
    return torch.gather(per_tool, -1, top_i)


def fused_select_ref(
    sel_scores: torch.Tensor,   # [n_q, n_tools], invalid = -inf/NEG
    val_scores: torch.Tensor,   # [n_q, n_tools]
    tool_qos: torch.Tensor,     # [n_q, n_tools] or [n_tools]
    tool_load: Optional[torch.Tensor] = None,  # U
    tool_dead: Optional[torch.Tensor] = None,  # >0 excludes from the argmax
    *,
    k: int,
    alpha,
    beta,
    gamma=0.0,
    temp: float = 1.0,
    tool_rtt: Optional[torch.Tensor] = None,   # R
    delta=0.0,
    tool_aff: Optional[torch.Tensor] = None,   # W
    eps: float = 0.0,
):
    """Stage-2 top-k (ties -> lower index), Eq. 5 softmax over the valid
    candidates, Eq. 8 fusion (-gamma*U, -delta*R, +eps*W), dead mask,
    argmax (first maximum).  Dead candidates keep their softmax mass; if
    every candidate is masked or invalid the top-selection one wins.
    The fusion weights may be floats or 0-d tensors (live weights).
    Returns (tool_idx i32, C, N, S), each [n_q]."""
    sel = torch.clamp_min(sel_scores.to(torch.float32), NEG)
    k = min(k, sel.shape[-1])
    top_v, top_i = topk(sel, k)                              # [n_q, k]
    valid = top_v > NEG / 2.0
    val = torch.gather(val_scores.to(torch.float32), -1, top_i)
    val = torch.where(valid, val, NEG)

    n = _gather(tool_qos, top_i)
    u = _gather(tool_load, top_i) if tool_load is not None else torch.zeros_like(n)
    r = _gather(tool_rtt, top_i) if tool_rtt is not None else torch.zeros_like(n)
    z = (val - torch.amax(val, dim=-1, keepdim=True)) / temp
    e = torch.exp(z)
    denom = e[:, 0]
    for j in range(1, k):
        denom = denom + e[:, j]
    c = e / torch.clamp_min(denom, 1e-30)[:, None]
    fused = alpha * c + beta * n - gamma * u - delta * r
    if tool_aff is not None:
        fused = fused + eps * _gather(tool_aff, top_i)
    s = torch.where(valid, fused, NEG)
    if tool_dead is not None:
        s = torch.where(_gather(tool_dead, top_i) > 0.0, NEG, s)
    best = torch.argmax(s, dim=-1, keepdim=True)             # first max wins

    def take(a):
        return torch.gather(a, -1, best)[:, 0]

    return take(top_i).to(torch.int32), take(c), take(n), take(s)


def candidate_mask(tool_server: torch.Tensor, cand_servers: torch.Tensor) -> torch.Tensor:
    """[n_q, n_tools] bool: does the tool's host server sit among the
    query's stage-1 candidates?"""
    return torch.any(
        tool_server[None, None, :] == cand_servers[:, :, None], dim=1
    )


def fused_score_select_ref(
    q_tool: torch.Tensor,        # [n_q, V]
    w_tool: torch.Tensor,        # [n_tools, V]
    tool_server: torch.Tensor,   # [n_tools] int
    cand_servers: torch.Tensor,  # [n_q, top_s] int
    tool_qos: torch.Tensor,
    tool_load: Optional[torch.Tensor] = None,
    tool_dead: Optional[torch.Tensor] = None,
    q_rerank: Optional[torch.Tensor] = None,
    *,
    k: int,
    alpha,
    beta,
    gamma=0.0,
    temp: float = 1.0,
    tool_rtt: Optional[torch.Tensor] = None,
    delta=0.0,
    tool_aff: Optional[torch.Tensor] = None,
    eps: float = 0.0,
):
    """Plain version of the fused kernel: materialise the stage-2 score
    matrix (BM25 product + candidate-server mask) and feed it to
    `fused_select_ref`, the unfused two-pass pipeline the kernel replaces."""
    t = bm25_scores(w_tool, q_tool)
    sel = torch.where(candidate_mask(tool_server, cand_servers), t, NEG)
    val = bm25_scores(w_tool, q_rerank) if q_rerank is not None else sel
    return fused_select_ref(
        sel, val, tool_qos, tool_load, tool_dead,
        k=k, alpha=alpha, beta=beta, gamma=gamma, temp=temp,
        tool_rtt=tool_rtt, delta=delta, tool_aff=tool_aff, eps=eps,
    )


def stage1_topk_ref(
    scores: torch.Tensor,                     # tiled [n_q, M] / dense [J, n_q, S]
    valid: torch.Tensor,                      # [J, S] bool
    server_gid: torch.Tensor,                 # [J, S] int
    k: int,
    *,
    doc_map: Optional[torch.Tensor] = None,   # [J, S] template of each server
    dead: Optional[torch.Tensor] = None,      # [J, 1|n_q, S], > 0 masks
):
    """Stage 1 of the sharded engine, shard by shard: the top ``k`` servers
    of every (shard, query) row, ties toward the lower index.  A tiled
    fleet's template scores are gathered through ``doc_map``; dead servers
    score NEG, shard pads (``valid`` false) PAD_NEG.  Returns (values
    [J, n_q, k], global server ids [J, n_q, k] from ``server_gid``)."""
    s = scores if doc_map is None else scores[:, doc_map.long()].permute(1, 0, 2)
    if dead is not None:
        s = torch.where(dead > 0.0, NEG, s)               # [J, 1|n_q, S] bcast
    s = torch.where(valid[:, None, :], s, PAD_NEG)
    v, li = topk(s, k)                                    # [J, n_q, k]
    gid = torch.gather(server_gid[:, None, :].expand(s.shape), -1, li)
    return v, gid


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

ATTN_NEG = -1e30   # the attention mask value (kernels and oracles agree)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hkv*n_rep, S, D] (GQA expansion)."""
    if n_rep == 1:
        return k
    B, H, S, D = k.shape
    return k[:, :, None].expand(B, H, n_rep, S, D).reshape(B, H * n_rep, S, D)


def mha_ref(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    *,
    sm_scale: float,
    causal: bool = True,
) -> torch.Tensor:
    """Naive full-softmax GQA attention (f32 math), in q's dtype.  Under
    ``causal`` column c of row r is visible when c <= r + (Sk - S)."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    k = repeat_kv(k, Hq // Hkv).to(torch.float32)
    v = repeat_kv(v, Hq // Hkv).to(torch.float32)
    s = torch.matmul(q.to(torch.float32), k.transpose(-1, -2)) * sm_scale
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask, diagonal=Sk - S)
    s = torch.where(mask, s, ATTN_NEG)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v).to(q.dtype)


def decode_ref(
    q: torch.Tensor,        # [B, Hkv, G, D]
    k: torch.Tensor,        # [B, Hkv, S, D]
    v: torch.Tensor,        # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B, 1] int
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Naive single-token GQA attention over a variable-length cache."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * sm_scale
    S = k.shape[2]
    mask = torch.arange(S, device=q.device)[None, :] < lengths.reshape(-1, 1)   # [B, S]
    s = torch.where(mask[:, None, None], s, ATTN_NEG)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def decode_split_ref(
    q: torch.Tensor,        # [B, Hkv, G, D]
    k: torch.Tensor,        # [B, Hkv, S, D]
    v: torch.Tensor,        # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] or [B, 1] int
    *,
    sm_scale: float,
    n_split: int,
) -> torch.Tensor:
    """Single-token GQA attention computed as the split-KV decode kernel
    does: the cache rows [0, S) cut into ``n_split`` even splits
    [s S / n, (s + 1) S / n); per split the partial state (m, l, acc) over
    its rows below the length (an empty split: m = -1e30, l = 0, acc = 0);
    then the splits merged in order with weights exp(m_s - max m) and the
    sum divided by max(l, 1e-30).  A sequence of length 0 gives 0, as the
    kernels and the reference's Pallas kernel do (`decode_ref`, a softmax
    over an all-masked row, gives the mean of V there)."""
    B, _, _, D = q.shape
    S = k.shape[2]
    if not 1 <= n_split <= S:
        raise ValueError(f"decode_split_ref: n_split {n_split} outside [1, {S}]")
    qf, kf, vf = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    lengths = lengths.reshape(B, 1)
    m_all, l_all, acc_all = [], [], []
    for s in range(n_split):
        lo, hi = s * S // n_split, (s + 1) * S // n_split
        rows = torch.arange(lo, hi, device=q.device)
        valid = (rows[None, :] < lengths)[:, None, None, :]                  # [B, 1, 1, rows]
        sc = torch.matmul(qf, kf[:, :, lo:hi].transpose(-1, -2)) * sm_scale  # [B, Hkv, G, rows]
        sc = torch.where(valid, sc, ATTN_NEG)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(sc - m), 0.0)
        m_all.append(m)
        l_all.append(p.sum(dim=-1, keepdim=True))
        acc_all.append(torch.matmul(p, vf[:, :, lo:hi]))
    m_max = torch.stack(m_all).amax(dim=0)
    num = torch.zeros_like(acc_all[0])
    den = torch.zeros_like(l_all[0])
    for m, l, acc in zip(m_all, l_all, acc_all):      # in split order
        w = torch.exp(m - m_max)
        num = num + w * acc
        den = den + w * l
    return (num / torch.clamp_min(den, 1e-30)).to(q.dtype)


def bf16_hi_lo(p: torch.Tensor):
    """f32 ``p`` -> (hi, lo) in bf16 with hi = bf16(p), lo = bf16(p - hi):
    hi + lo carries p to about 2^-17 relative (the subtraction is exact)."""
    p = p.to(torch.float32)
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.to(torch.float32)).to(torch.bfloat16)
