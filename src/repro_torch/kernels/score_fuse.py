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
_ROWS = ("tool_qos", "tool_load", "tool_rtt", "tool_dead", "tool_aff")
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
    rows: dict,                       # name in _ROWS -> f32 [n_tools] / [n_q, n_tools] / None
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
    ptrs = (ctypes.c_void_p * len(_ROWS))()
    strides = (ctypes.c_longlong * len(_ROWS))()
    for j, name in enumerate(_ROWS):
        t = rows.get(name)
        if t is None:
            if name == "tool_qos":
                raise ValueError("fused_score_select: tool_qos is required")
            continue
        _build.require(t, f"fused_score_select {name}", t.ndim, (torch.float32,))
        if t.shape[-1] != n_t or t.ndim not in (1, 2) or (t.ndim == 2 and t.shape[0] != n_q):
            raise ValueError(f"fused_score_select: {name} shape {tuple(t.shape)}")
        ptrs[j] = t.data_ptr()
        strides[j] = n_t if t.ndim == 2 else 0
    wl = None
    if live_weights is not None:
        wl = _build.require(live_weights, "fused_score_select live_weights", 1, (torch.float32,))
        if wl.shape[0] != 4:
            raise ValueError("fused_score_select: live weights are [alpha, beta, gamma, delta]")
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
        None if wl is None else wl.data_ptr(),
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
