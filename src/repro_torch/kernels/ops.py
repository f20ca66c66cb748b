"""Entry points of the port's kernels, twin of `repro.kernels.ops`.

Each wrapper dispatches on where its tensors lie: CPU tensors go to the
plain PyTorch version, CUDA tensors to the hand-written CUDA kernel, which
either launches or raises (there is no fallback).  On ``meta`` tensors
(the dry-run, `repro_torch.launch.dryrun`) a wrapper launches nothing: it
returns empty tensors of the kernel's result shapes and dtypes and tells
the listeners in `meta_listeners` the work the kernel would do, the
operations and bytes `chip_smoke.py`'s phase 4 reckons for its bound
(meta tensors hold no data, so data-dependent work is counted whole: every
BM25 column, every candidate pair, every cache row).  Operands on mixed
devices raise.  Each kernel launcher keeps an integer count of its
launches (`launch_counts`), so a run can show that it went through the
kernels; a meta call counts none.  The two attention wrappers are forward
only: a call that autograd would record raises, on the CPU, the card and
meta alike.
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
from repro_torch.kernels import stage1_topk as _s1

_LAUNCHERS = {
    "bm25_scores": _bm25.bm25_scores_cuda,
    "qos_scores": _qos.qos_scores_cuda,
    "fused_score_select": _scf.fused_score_select_cuda,
    "fused_select": _sel.fused_select_cuda,
    "flash_attention": _fa.flash_attention_cuda,
    "decode_attention": _dec.decode_attention_cuda,
    "stage1_topk": _s1.stage1_topk_cuda,
}


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


def reset_launches() -> None:
    for fn in _LAUNCHERS.values():
        fn.launches = 0


def _forward_only(name: str, *tensors) -> None:
    """The attention kernels have no backward (nor has the reference's
    Pallas kernel: `jax.grad` through it raises), so a call that autograd
    would record raises on either device instead of returning a result
    without a gradient."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"repro_torch.ops.{name}: the kernel is forward only and an operand requires "
            "grad; train with attn_impl='naive' or 'chunked', or call it under torch.no_grad()")


def _where(*tensors) -> str:
    """"cpu", "cuda" or "meta": the one device type of the tensor operands
    (no tensor counts as the CPU); a mix raises."""
    kinds = {t.device.type for t in tensors if isinstance(t, torch.Tensor)}
    if kinds <= {"cpu"}:
        return "cpu"
    if kinds in ({"cuda"}, {"meta"}):
        return kinds.pop()
    raise ValueError(f"repro_torch.ops: operands on mixed devices {sorted(kinds)}")


# callables (name, n_ops, n_bytes, ops_dtype) told of each kernel call on
# meta tensors; `repro_torch.launch.hlo_analysis.StepCounter` adds itself
meta_listeners: list = []


def _meta_call(name: str, n_ops, n_bytes, ops_dtype: torch.dtype, *outs):
    """A kernel call on meta tensors: report its work, launch nothing, and
    return ``outs`` (empty meta tensors of the result shapes)."""
    for fn in meta_listeners:
        fn(name, float(n_ops), float(n_bytes), ops_dtype)
    return outs[0] if len(outs) == 1 else outs


def _nbytes(*tensors) -> int:
    """Bytes of the distinct tensors among ``tensors`` (None skipped)."""
    seen = {id(t): t for t in tensors if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in seen.values())


def _empty_meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _winners_meta(name: str, n_q: int, n_ops, n_bytes):
    """The selection kernels' four results (tool_idx i32, C, N, S) on meta."""
    return _meta_call(name, n_ops, n_bytes, torch.float32,
                      _empty_meta((n_q,), torch.int32),
                      *(_empty_meta((n_q,), torch.float32) for _ in range(3)))


# ---------------------------------------------------------------------------
# BM25
# ---------------------------------------------------------------------------

def bm25_scores(qcounts: torch.Tensor, weights_t: torch.Tensor) -> torch.Tensor:
    """scores [n_q, n_docs] = qcounts [n_q, V] @ weights_t [V, n_docs].

    The weights come transposed, the layout the kernel reads (a used term is
    one contiguous row); the engines keep their static weights so.  f32 and
    bf16 weights go to the kernel as they are."""
    where = _where(qcounts, weights_t)
    if where == "meta":
        (n_q, V), n_docs = qcounts.shape, weights_t.shape[1]
        return _meta_call("bm25_scores", 2 * n_q * V * n_docs,
                          4 * (qcounts.numel() + n_q * n_docs) + _nbytes(weights_t),
                          torch.float32, _empty_meta((n_q, n_docs), torch.float32))
    if where == "cpu":
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
    where = _where(lat)
    if where == "meta":
        return _meta_call("qos_scores", 12 * lat.numel(), _nbytes(lat) + 4 * lat.shape[0],
                          torch.float32, _empty_meta(lat.shape[:1], torch.float32))
    if where == "cpu":
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
    where = _where(sel_scores, val_scores, *extras)
    if where == "meta":
        n_q, n_tools = sel_scores.shape
        return _winners_meta("fused_select", n_q, n_q * (k * n_tools + 12 * k),
                             _nbytes(sel_scores, val_scores, *extras) + 16 * n_q)
    if where == "cpu":
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
# The sharded engine's stage 1: per-shard top-s
# ---------------------------------------------------------------------------

def stage1_topk(
    scores: torch.Tensor,                     # tiled [n_q, M] / dense [J, n_q, S]
    valid: torch.Tensor,                      # [J, S] bool
    server_gid: torch.Tensor,                 # [J, S] int
    k: int,
    *,
    doc_map: Optional[torch.Tensor] = None,   # [J, S] template of each server
    dead: Optional[torch.Tensor] = None,      # [J, 1|n_q, S], > 0 masks
):
    """(values [J, n_q, k] f32, global ids [J, n_q, k] i32): the top ``k``
    servers of each (shard, query) row under (score desc, index asc), dead
    servers scoring NEG and shard pads PAD_NEG.  With ``doc_map`` the
    scores are template scores read through it in place (a tiled fleet);
    nothing ``[J, n_q, S]``-sized is written on the card.  ``k`` above the
    kernel's K_MAX, or more than its TPL_MAX templates, raises on the card."""
    where = _where(scores, valid, server_gid, doc_map, dead)
    if where == "meta":
        J, S = valid.shape
        n_q = scores.shape[0] if doc_map is not None else scores.shape[1]
        return _meta_call("stage1_topk", J * n_q * S,      # one compare an entry
                          _nbytes(scores, valid, doc_map, dead) + 12 * J * n_q * k,
                          torch.float32, _empty_meta((J, n_q, k), torch.float32),
                          _empty_meta((J, n_q, k), torch.int32))
    if where == "cpu":
        return kref.stage1_topk_ref(scores, valid, server_gid, k, doc_map=doc_map, dead=dead)
    return _s1.stage1_topk_cuda(
        scores.to(torch.float32).contiguous(), valid.to(torch.bool).contiguous(),
        server_gid.to(torch.int32).contiguous(), k,
        doc_map=None if doc_map is None else doc_map.to(torch.int32).contiguous(),
        dead=None if dead is None else dead.to(torch.float32).contiguous())


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
    where = _where(q_tool, w_tool, tool_server, cand_servers, *extras)
    if where == "meta":
        (n_q, V), n_tools = q_tool.shape, w_tool.shape[0]
        return _winners_meta("fused_score_select", n_q, 2 * n_q * n_tools * V,
                             4 * (q_tool.numel() + cand_servers.numel() + tool_server.numel()
                                  + n_tools * (V + 3) + 4 * n_q))
    if where == "cpu":
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
    (`flash_attention.HEAD_DIMS`) is zero-padded to the next one.  Forward
    only, on both devices: under grad mode an operand that requires grad
    raises (`_forward_only`)."""
    _forward_only("flash_attention", q, k, v)
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    where = _where(q, k, v)
    if where == "meta":
        B, Hq, Sq, D = q.shape
        pairs = Sq * k.shape[2] / (2 if causal else 1)
        return _meta_call("flash_attention", 4 * B * Hq * pairs * D,
                          q.element_size() * (2 * q.numel() + k.numel() + v.numel()), q.dtype,
                          _empty_meta(q.shape, q.dtype))
    if where == "cpu":
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
    _forward_only("decode_attention", q, k, v)
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    sm_scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    where = _where(q, k, v, lengths)
    if where == "meta":
        return _meta_call("decode_attention", 4 * B * Hq * k.shape[2] * D,
                          q.element_size() * (k.numel() + v.numel() + 2 * q.numel()), q.dtype,
                          _empty_meta(q.shape, q.dtype))
    if where == "cpu":
        out = kref.decode_ref(qg, k, v, lengths.reshape(B, 1), sm_scale=sm_scale)
    else:
        if lengths.dtype != torch.int32 or not lengths.is_contiguous():
            lengths = lengths.to(torch.int32).contiguous()
        out = with_padded_head(
            lambda q_, k_, v_: _dec.decode_attention_cuda(q_, k_, v_, lengths, sm_scale=sm_scale),
            qg, k, v, width=_fa.padded_head_dim(D))
    return out.reshape(B, Hq, D)
