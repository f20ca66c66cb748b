"""Fused stage-2 scoring on the card: launcher of ``csrc/score_fuse.cu``.

Tool scoring, candidate mask, streaming top-k, softmax expertise, fusion
and argmax in one pass per query (see the source's note).  Replaces the
Pallas kernel `repro.kernels.score_fuse._score_kernel`; the plain version
is `repro_torch.kernels.ref.fused_score_select_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

K_MAX = 128     # largest top-k the kernel keeps
S_MAX = 128     # largest stage-1 candidate count
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("score_fuse").fused_score_select
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, i, p, i, p, p,          # q, qr, q_bf16, w, w_bf16, host, cand
            p, p,                         # rows_ptr[5], rows_stride[5]
            p, f, f, f, f, f, i, f,       # wlive, alpha..delta, eps, use_aff, temp
            i, i, i, i, i,                # n_q, n_t, V, top_s, k
            p, p, p, p, p,                # idx, c, n, s, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


_QW = (torch.float32, torch.bfloat16)


def fused_score_select_cuda(
    q_tool: torch.Tensor,             # [n_q, V] f32/bf16
    w_tool: torch.Tensor,             # [n_tools, V] f32/bf16
    tool_server: torch.Tensor,        # [n_tools] i32
    cand_servers: torch.Tensor,       # [n_q, top_s] i32
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
    [n_q].  Adds one to ``fused_score_select_cuda.launches`` per launch."""
    q = _build.require(q_tool, "fused_score_select q_tool", 2, _QW)
    w = _build.require(w_tool, "fused_score_select w_tool", 2, _QW)
    host = _build.require(tool_server, "fused_score_select tool_server", 1, (torch.int32,))
    cand = _build.require(cand_servers, "fused_score_select cand_servers", 2, (torch.int32,))
    n_q, V = q.shape
    n_t = w.shape[0]
    top_s = cand.shape[1]
    if w.shape[1] != V or host.shape[0] != n_t or cand.shape[0] != n_q:
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
    idx = torch.empty((n_q,), dtype=torch.int32, device=dev)
    c, n, s = (torch.empty((n_q,), dtype=torch.float32, device=dev) for _ in range(3))
    if n_q == 0:
        return idx, c, n, s
    err = _fn()(
        q.data_ptr(), None if q_rerank is None else q_rerank.data_ptr(),
        int(q.dtype == torch.bfloat16), w.data_ptr(), int(w.dtype == torch.bfloat16),
        host.data_ptr(), cand.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
        wl,
        float(alpha), float(beta), float(gamma), float(delta), float(eps),
        int(rows.get("tool_aff") is not None), float(temp),
        n_q, n_t, V, top_s, int(k),
        idx.data_ptr(), c.data_ptr(), n.data_ptr(), s.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "fused_score_select kernel")
    fused_score_select_cuda.launches += 1
    return idx, c, n, s


fused_score_select_cuda.launches = 0
