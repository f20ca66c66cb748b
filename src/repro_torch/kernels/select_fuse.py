"""Fused selection tail on the card: launcher of ``csrc/select_fuse.cu``.

Top-k over materialised stage-2 scores (ties toward the lower index),
softmax expertise, fusion and argmax at any row width: a warp per query
on narrow rows, a block per query on wide ones, as `launch_plan` decides
(see the source's note).  Replaces the Pallas kernel
`repro.kernels.select_fuse._select_kernel`; the plain version is
`repro_torch.kernels.ref.fused_select_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

K_MAX = 128              # largest top-k the kernel keeps
NARROW_MAX = 256         # widest row one warp sorts in registers
SMEM_MAX = 232_448       # shared memory a block may use on the H100
WIDE_DYN_MAX = SMEM_MAX - 16_384   # a wide row's staged keys (the static arrays aside)
_FN = None


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    """How the kernel takes a [n_q, n_t] row set."""

    per_lane: int    # narrow rows: keys a lane holds (1, 2, 4, 8); 0: wide rows
    staged: bool     # wide rows: the row's keys staged in shared memory once
    dyn_smem: int    # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=256)
def launch_plan(n_t: int) -> SelectPlan:
    """Rows up to NARROW_MAX entries go to a warp each (32 * per_lane >=
    n_t); wider rows to a block each, their 4-byte keys staged in shared
    memory while they fit in WIDE_DYN_MAX, else read again from global
    memory by each later pass over the row."""
    if n_t <= NARROW_MAX:
        return SelectPlan(per_lane=1 << max(0, (n_t + 31) // 32 - 1).bit_length(),
                          staged=False, dyn_smem=0)
    staged = 4 * n_t <= WIDE_DYN_MAX
    return SelectPlan(per_lane=0, staged=staged, dyn_smem=4 * n_t if staged else 0)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("select_fuse").fused_select
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        fn.argtypes = [
            p, p, i,                      # sel, val, val_bf16
            p, p, p, p, p,                # qos, load, rtt, dead, aff rows
            ll, ll, ll, ll, ll,           # their strides
            p, f, f, f, f, f, i, f,       # wlive, alpha..delta, eps, use_aff, temp
            i, i, i, i, i,                # n_q, n_t, k, per_lane, staged
            p, p, p, p, p,                # idx, c, n, s, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fused_select_cuda(
    sel: torch.Tensor,                # [n_q, n_tools] f32 (the kernel clamps to NEG)
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
    out = torch.empty((4, n_q), dtype=torch.float32, device=dev)   # one allocation
    idx, c, n, s = out[0].view(torch.int32), out[1], out[2], out[3]
    if n_q == 0:
        return idx, c, n, s
    plan = launch_plan(n_t)
    err = _fn()(
        sel.data_ptr(), val.data_ptr(), int(val.dtype == torch.bfloat16),
        *ptrs, *strides, wl,
        float(alpha), float(beta), float(gamma), float(delta), float(eps),
        int(rows.get("tool_aff") is not None), float(temp),
        n_q, n_t, int(k), plan.per_lane, int(plan.staged),
        idx.data_ptr(), c.data_ptr(), n.data_ptr(), s.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "fused_select kernel")
    fused_select_cuda.launches += 1
    return idx, c, n, s


fused_select_cuda.launches = 0
