"""Fused stage-2 scoring on the card: launcher of ``csrc/score_fuse.cu``.

Tool scoring over the tools of each query's candidate servers, streaming
top-k, softmax expertise, fusion and argmax, one warp per query (see the
source's note).  The candidates' tools come from a server -> tools map in
CSR form (`tool_csr`, plain tensor code on any device), which an engine
builds once beside its index.  Replaces the
Pallas kernel `repro.kernels.score_fuse._score_kernel`; the plain version
is `repro_torch.kernels.ref.fused_score_select_ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

K_MAX = 128     # largest top-k the kernel keeps
S_MAX = 128     # largest stage-1 candidate count
_FN = None


class ToolCsr(NamedTuple):
    """Server -> tools map: server ``s`` hosts ``tools[offsets[s]:offsets[s + 1]]``.

    ``tools`` [n_tools] i32 holds the tool ids grouped by host server,
    ascending within a server; ``offsets`` [n_servers + 1] i32."""

    offsets: torch.Tensor
    tools: torch.Tensor


def tool_csr(tool_server: torch.Tensor, n_servers: int) -> ToolCsr:
    """The CSR map of ``tool_server`` [n_tools] (host server per tool, ids in
    [0, n_servers)), on its device: a stable sort, so it is the identity
    order when the tools come grouped by server, as a `ToolIndex` lists
    them."""
    ts = tool_server.long()
    order = torch.sort(ts, stable=True)
    offsets = torch.searchsorted(
        order.values, torch.arange(n_servers + 1, device=ts.device, dtype=torch.long))
    return ToolCsr(offsets.to(torch.int32), order.indices.to(torch.int32))


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("score_fuse").fused_score_select
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, i, p, i,                # q, qr, q_bf16, w, w_bf16
            p, p, p,                      # tools, offsets, cand
            p, p,                         # rows_ptr[5], rows_stride[5]
            p, f, f, f, f, f, i, f,       # wlive, alpha..delta, eps, use_aff, temp
            i, i, i, i,                   # n_q, V, top_s, k
            p, p, p, p, p,                # idx, c, n, s, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


_QW = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)


def fused_score_select_cuda(
    q_tool: torch.Tensor,             # [n_q, V] f32/bf16
    w_tool: torch.Tensor,             # [n_tools, V] f32/bf16
    csr: ToolCsr,                     # server -> tools map of the tools' hosts
    cand_servers: torch.Tensor,       # [n_q, top_s] i32 server ids
    rows: dict,                       # _build.ROWS name -> f32 row or None
    q_rerank: Optional[torch.Tensor],  # [n_q, V] like q_tool, or None
    *,
    k: int,
    alpha: float,
    beta: float,
    gamma: float,
    delta: float,
    eps: float,
    temp: float,
    live_weights: Optional[torch.Tensor] = None,  # [4] f32 on the card
):
    """Launch the fused kernel; returns (tool_idx i32, C, N, S) f32, each
    [n_q].  The candidates' ids must lie in [0, n_servers) of ``csr``.
    Adds one to ``fused_score_select_cuda.launches`` per launch."""
    q = _build.require(q_tool, "fused_score_select q_tool", 2, _QW)
    w = _build.require(w_tool, "fused_score_select w_tool", 2, _QW)
    tools = _build.require(csr.tools, "fused_score_select tools", 1, _I32)
    offsets = _build.require(csr.offsets, "fused_score_select offsets", 1, _I32)
    cand = _build.require(cand_servers, "fused_score_select cand_servers", 2, _I32)
    n_q, V = q.shape
    n_t = w.shape[0]
    top_s = cand.shape[1]
    if w.shape[1] != V or tools.shape[0] != n_t or cand.shape[0] != n_q:
        raise ValueError("fused_score_select: operand shapes disagree")
    if not (1 <= k <= K_MAX) or top_s > S_MAX:
        raise ValueError(f"fused_score_select: k={k} (max {K_MAX}), top_s={top_s} (max {S_MAX})")
    if q_rerank is not None:
        qr = _build.require(q_rerank, "fused_score_select q_rerank", 2, (q.dtype,))
        if qr.shape != q.shape:
            raise ValueError("fused_score_select: q_rerank shape differs from q_tool")
    ptrs, strides = _build.pack_rows(rows, n_q, n_t, "fused_score_select")
    wl = _build.live_weights_ptr(live_weights, "fused_score_select")
    dev = q.device
    out = torch.empty((4, n_q), dtype=torch.float32, device=dev)    # one allocation
    idx, c, n, s = out[0].view(torch.int32), out[1], out[2], out[3]
    if n_q == 0:
        return idx, c, n, s
    err = _fn()(
        q.data_ptr(), None if q_rerank is None else q_rerank.data_ptr(),
        int(q.dtype == torch.bfloat16), w.data_ptr(), int(w.dtype == torch.bfloat16),
        tools.data_ptr(), offsets.data_ptr(), cand.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
        wl,
        float(alpha), float(beta), float(gamma), float(delta), float(eps),
        int(rows.get("tool_aff") is not None), float(temp),
        n_q, V, top_s, int(k),
        idx.data_ptr(), c.data_ptr(), n.data_ptr(), s.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "fused_score_select kernel")
    fused_score_select_cuda.launches += 1
    return idx, c, n, s


fused_score_select_cuda.launches = 0
