"""Entry points of the port's kernels, twin of `repro.kernels.ops`.

Each wrapper dispatches on where its tensors lie: CPU tensors go to the
plain PyTorch version, CUDA tensors to the hand-written CUDA kernel, which
either launches or raises (there is no fallback).  Operands on mixed
devices raise.  Each kernel launcher keeps an integer count of its
launches (`launch_counts`), so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.bm25 import bm25_scores as _bm25_plain
from repro_torch.core.qos import DEFAULT_QOS, QosParams, network_score
from repro_torch.kernels import bm25_score as _bm25
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import qos_score as _qos
from repro_torch.kernels import ref as kref
from repro_torch.kernels import score_fuse as _scf
from repro_torch.kernels import select_fuse as _sel

_LAUNCHERS = {
    "bm25_scores": _bm25.bm25_scores_cuda,
    "qos_scores": _qos.qos_scores_cuda,
    "fused_score_select": _scf.fused_score_select_cuda,
    "fused_select": _sel.fused_select_cuda,
    "flash_attention": _fa.flash_attention_cuda,
    "decode_attention": _dec.decode_attention_cuda,
}


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


def reset_launches() -> None:
    for fn in _LAUNCHERS.values():
        fn.launches = 0


def _on_cuda(*tensors) -> bool:
    kinds = {t.device.type for t in tensors if isinstance(t, torch.Tensor)}
    if kinds <= {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"repro_torch.ops: operands on mixed devices {sorted(kinds)}")


# ---------------------------------------------------------------------------
# BM25
# ---------------------------------------------------------------------------

def bm25_scores(qcounts: torch.Tensor, weights_t: torch.Tensor) -> torch.Tensor:
    """scores [n_q, n_docs] = qcounts [n_q, V] @ weights_t [V, n_docs].

    The weights come transposed, the layout the kernel reads (a used term is
    one contiguous row); the engines keep their static weights so.  f32 and
    bf16 weights go to the kernel as they are."""
    if not _on_cuda(qcounts, weights_t):
        return _bm25_plain(weights_t.t(), qcounts)
    if weights_t.dtype not in (torch.float32, torch.bfloat16):
        weights_t = weights_t.to(torch.float32)
    return _bm25.bm25_scores_cuda(qcounts.to(torch.float32).contiguous(),
                                  weights_t.contiguous())


# ---------------------------------------------------------------------------
# QoS
# ---------------------------------------------------------------------------

def qos_scores(lat: torch.Tensor, params: QosParams = DEFAULT_QOS) -> torch.Tensor:
    """Fleet QoS scores N [n] from windows lat [n, T] (Eq. 7)."""
    if not _on_cuda(lat):
        return network_score(lat, params)
    if lat.dtype != torch.bfloat16:
        lat = lat.to(torch.float32)
    return _qos.qos_scores_cuda(lat.contiguous(), params)


def _live_weights(alpha, beta, gamma, delta, dev):
    """(static weights, live [4] f32 vector or None): a fusion weight given
    as a tensor makes all four live, read by the kernel from the card."""
    weights = (alpha, beta, gamma, delta)
    if not any(isinstance(x, torch.Tensor) for x in weights):
        return weights, None
    live = torch.stack([
        torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(()) for x in weights
    ])
    return (0.0, 0.0, 0.0, 0.0), live


def _row(x):
    return None if x is None else x.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Fused selection over materialised scores (top-k + softmax + fusion + argmax)
# ---------------------------------------------------------------------------

def fused_select(
    sel_scores: torch.Tensor,   # [n_q, n_tools] stage-2 scores, invalid = -inf/NEG
    val_scores: torch.Tensor,   # [n_q, n_tools] softmax-value scores (== sel
                                # except under rerank)
    tool_qos: torch.Tensor,     # [n_q, n_tools] or [n_tools] per-tool N
    tool_load: Optional[torch.Tensor] = None,   # U
    tool_dead: Optional[torch.Tensor] = None,   # >0 excludes from the argmax
    *,
    k: int,
    alpha,
    beta,
    gamma=0.0,
    temp: float = 1.0,
    tool_rtt: Optional[torch.Tensor] = None,    # R
    delta=0.0,
    tool_aff: Optional[torch.Tensor] = None,    # W
    eps: float = 0.0,
):
    """Winning (tool_idx i32, C, N, S) per query: the stage-2 top-k (ties
    toward the lower index), softmax, fusion and argmax tail of
    `Router.select`.  ``sel`` is clamped to NEG first, so -inf marks an
    invalid candidate.  Rows are broadcast [n_tools] or per query; fusion
    weights are floats or 0-d tensors (then all four are live); ``k`` is
    cut to ``n_tools``, and above the kernel's K_MAX it raises."""
    k = min(k, sel_scores.shape[-1])
    extras = (tool_qos, tool_load, tool_dead, tool_rtt, tool_aff)
    if not _on_cuda(sel_scores, val_scores, *extras):
        return kref.fused_select_ref(
            sel_scores, val_scores, tool_qos, tool_load, tool_dead, k=k, alpha=alpha,
            beta=beta, gamma=gamma, temp=temp, tool_rtt=tool_rtt, delta=delta,
            tool_aff=tool_aff, eps=eps,
        )
    weights, live = _live_weights(alpha, beta, gamma, delta, sel_scores.device)
    sel = sel_scores.to(torch.float32).contiguous()       # the kernel clamps to NEG
    if val_scores.dtype != torch.bfloat16:
        val_scores = val_scores.to(torch.float32)
    return _sel.fused_select_cuda(
        sel, val_scores.contiguous(),
        {
            "tool_qos": _row(tool_qos), "tool_load": _row(tool_load),
            "tool_rtt": _row(tool_rtt), "tool_dead": _row(tool_dead),
            "tool_aff": _row(tool_aff),
        },
        k=k, alpha=weights[0], beta=weights[1], gamma=weights[2], delta=weights[3],
        eps=eps, temp=temp, live_weights=live,
    )


# ---------------------------------------------------------------------------
# Single-pass fused stage 2
# ---------------------------------------------------------------------------

def fused_score_select(
    q_tool: torch.Tensor,        # [n_q, V] stage-2 query term counts (f32/bf16)
    w_tool: torch.Tensor,        # [n_tools, V] tool corpus weights (f32/bf16)
    tool_server: torch.Tensor,   # [n_tools] host server per tool
    cand_servers: torch.Tensor,  # [n_q, top_s] stage-1 candidates
    tool_qos: torch.Tensor,      # [n_q, n_tools] or [n_tools] per-tool N
    tool_load: Optional[torch.Tensor] = None,
    tool_dead: Optional[torch.Tensor] = None,
    q_rerank: Optional[torch.Tensor] = None,   # [n_q, V] (RerankRAG)
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
    tool_csr: Optional[_scf.ToolCsr] = None,
):
    """Winning (tool_idx i32, C, N, S) per query, the stage-2 matrix never
    materialised on the card.  A fusion weight given as a tensor makes all
    four live: the kernel reads them from a [4] f32 device vector, so a
    weight change needs no rebuild and no host sync.  ``tool_csr`` is the
    `score_fuse.ToolCsr` of ``tool_server`` (an engine builds it once);
    without it the map is built here, after one host sync for the server
    count.  Candidates are server ids in [0, n_servers) (a stage-1 top-s
    gives them distinct; a repeated one is walked once)."""
    k = min(k, w_tool.shape[0])
    extras = (tool_qos, tool_load, tool_dead, q_rerank, tool_rtt, tool_aff)
    if not _on_cuda(q_tool, w_tool, tool_server, cand_servers, *extras):
        return kref.fused_score_select_ref(
            q_tool, w_tool, tool_server, cand_servers, tool_qos, tool_load,
            tool_dead, q_rerank, k=k, alpha=alpha, beta=beta, gamma=gamma,
            temp=temp, tool_rtt=tool_rtt, delta=delta, tool_aff=tool_aff, eps=eps,
        )
    weights, live = _live_weights(alpha, beta, gamma, delta, q_tool.device)

    def operand(x, dtype=None):        # f32 or bf16 storage, widened in the kernel
        if dtype is None:
            dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) else torch.float32
        return x.to(dtype).contiguous()

    cand = cand_servers.to(torch.int32).contiguous()    # the top-s slice: one copy
    if tool_csr is None:
        ids = torch.cat([tool_server.reshape(-1).long(), cand.reshape(-1).long(),
                         cand.new_zeros(1, dtype=torch.long)])
        tool_csr = _scf.tool_csr(tool_server, int(ids.max()) + 1)
    q = operand(q_tool)
    return _scf.fused_score_select_cuda(
        q, operand(w_tool), tool_csr, cand,
        {
            "tool_qos": _row(tool_qos), "tool_load": _row(tool_load),
            "tool_rtt": _row(tool_rtt), "tool_dead": _row(tool_dead),
            "tool_aff": _row(tool_aff),
        },
        None if q_rerank is None else operand(q_rerank, q.dtype),
        k=k, alpha=weights[0], beta=weights[1], gamma=weights[2], delta=weights[3],
        eps=eps, temp=temp, live_weights=live,
    )


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def with_padded_head(fn, *tensors: torch.Tensor, width: int):
    """``fn(*tensors)`` with each operand's head dim (the last) zero-padded
    to ``width``, and the result's sliced back to the original D.  Exact for
    attention whose scale was fixed from the original D: the padded terms
    of q.k are 0, and the padded V columns only fill the sliced-off ones."""
    D = tensors[0].shape[-1]
    if width == D:
        return fn(*tensors)
    padded = [torch.nn.functional.pad(t, (0, width - D)) for t in tensors]
    return fn(*padded)[..., :D]


def flash_attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Causal/GQA attention softmax(q k^T / sqrt(D)) v with f32 math, in q's
    dtype.  Any S, no padding; on the card any strides with a contiguous
    last dim (a transposed view of [B, S, H, D] goes in without a copy) and
    all three in one dtype, float32 or bfloat16.  The causal mask is
    bottom-right, ``tril(k=Sk - Sq)`` as `mha_ref` has it, not the Pallas
    kernel's top-left, so with Sq < Sk the queries are the last Sq
    positions.  On the card a head dim between the kernel's widths
    (`flash_attention.HEAD_DIMS`) is zero-padded to the next one."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_cuda(q, k, v):
        return kref.mha_ref(q, k, v, sm_scale=sm_scale, causal=causal)
    return with_padded_head(
        lambda q_, k_, v_: _fa.flash_attention_cuda(q_, k_, v_, sm_scale=sm_scale, causal=causal),
        q, k, v, width=_fa.padded_head_dim(q.shape[-1]))


def decode_attention(
    q: torch.Tensor,        # [B, Hq, D]: one new token per sequence
    k: torch.Tensor,        # [B, Hkv, S, D]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid cache lengths
) -> torch.Tensor:
    """Single-token GQA attention over a variable-length cache (scale
    1/sqrt(D)) -> [B, Hq, D] in q's dtype.  On the card k/v may be any
    strided view with a contiguous last dim (the model's [B, S, Hkv, D]
    cache, transposed); a head dim between the kernel's widths is
    zero-padded to the next one (a copy of the cache per call)."""
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    sm_scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    if not _on_cuda(q, k, v, lengths):
        out = kref.decode_ref(qg, k, v, lengths.reshape(B, 1), sm_scale=sm_scale)
    else:
        if lengths.dtype != torch.int32 or not lengths.is_contiguous():
            lengths = lengths.to(torch.int32).contiguous()
        out = with_padded_head(
            lambda q_, k_, v_: _dec.decode_attention_cuda(q_, k_, v_, lengths, sm_scale=sm_scale),
            qg, k, v, width=_fa.padded_head_dim(D))
    return out.reshape(B, Hq, D)
