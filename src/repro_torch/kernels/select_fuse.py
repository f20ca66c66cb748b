"""Fused selection tail on the card: launcher of ``csrc/select_fuse.cu``.

Top-k over materialised stage-2 scores (ties toward the lower index),
softmax expertise, fusion and argmax, one block per query at any row width
(see the source's note).  Replaces the Pallas kernel
`repro.kernels.select_fuse._select_kernel`; the plain version is
`repro_torch.kernels.ref.fused_select_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

K_MAX = 128     # largest top-k the kernel keeps
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("select_fuse").fused_select
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, i,                      # sel, val, val_bf16
            p, p,                         # rows_ptr[5], rows_stride[5]
            p, f, f, f, f, f, i, f,       # wlive, alpha..delta, eps, use_aff, temp
            i, i, i,                      # n_q, n_t, k
            p, p, p, p, p,                # idx, c, n, s, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fused_select_cuda(
    sel: torch.Tensor,                # [n_q, n_tools] f32, clamped to >= NEG
    val: torch.Tensor,                # [n_q, n_tools] f32/bf16
    rows: dict,                       # _build.ROWS name -> f32 row or None
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
    """Launch the selection kernel; returns (tool_idx i32, C, N, S) f32,
    each [n_q].  Adds one to ``fused_select_cuda.launches`` per launch."""
    sel = _build.require(sel, "fused_select sel", 2, (torch.float32,))
    val = _build.require(val, "fused_select val", 2, (torch.float32, torch.bfloat16))
    n_q, n_t = sel.shape
    if val.shape != sel.shape or val.device != sel.device:
        raise ValueError("fused_select: sel and val differ in shape or device")
    if not (1 <= k <= min(K_MAX, n_t)):
        raise ValueError(f"fused_select: k={k} outside [1, min({K_MAX}, n_tools={n_t})]")
    ptrs, strides = _build.pack_rows(rows, n_q, n_t, "fused_select")
    wl = _build.live_weights_ptr(live_weights, "fused_select")
    dev = sel.device
    idx = torch.empty((n_q,), dtype=torch.int32, device=dev)
    c, n, s = (torch.empty((n_q,), dtype=torch.float32, device=dev) for _ in range(3))
    if n_q == 0:
        return idx, c, n, s
    err = _fn()(
        sel.data_ptr(), val.data_ptr(), int(val.dtype == torch.bfloat16),
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
        wl,
        float(alpha), float(beta), float(gamma), float(delta), float(eps),
        int(rows.get("tool_aff") is not None), float(temp),
        n_q, n_t, int(k),
        idx.data_ptr(), c.data_ptr(), n.data_ptr(), s.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "fused_select kernel")
    fused_select_cuda.launches += 1
    return idx, c, n, s


fused_select_cuda.launches = 0
