"""Flash attention on the card: launcher of ``csrc/flash_attention.cu``.

Causal/GQA online-softmax attention with the softmax state and P in f32,
over bf16 operands on the tensor cores (wgmma, P carried as two bf16
terms) or f32 operands on the CUDA cores, each addressed through its own
(batch, head, sequence) strides with a contiguous last dim, so both the op
layout [B, H, S, D] and transposed views of the model's [B, S, H, D]
activations go in without a copy.  Replaces the Pallas kernel
`repro.kernels.flash_attention._flash_kernel`; the plain version is
`repro_torch.kernels.ref.mha_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's compiled head widths
_FN = None
_STRIDES = ctypes.c_longlong * 12


def padded_head_dim(D: int) -> int:
    """The compiled width a head dim ``D`` runs at: the least entry of
    HEAD_DIMS that holds it (`ops` zero-pads up to it)."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    raise ValueError(f"head_dim {D} above the widest compiled width {HEAD_DIMS[-1]}")


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("flash_attention").flash_attention
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, p, p,          # q, k, v, out
            i, i, p,             # is_bf16, D, strides[12]
            i, i, i, i, i,       # B, Hq, Hkv, Sq, Sk
            f, i, p,             # scale, causal, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def check_operand(t: torch.Tensor, what: str, dtype: torch.dtype) -> torch.Tensor:
    """A 4-D CUDA operand of ``dtype`` whose rows the kernels read as
    16-byte vectors: contiguous last dim, 16-byte aligned start and strides."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {t.dtype}; expected {dtype} (float32 or bfloat16)")
    if t.ndim != 4:
        raise ValueError(f"{what}: expected 4 dims, got shape {tuple(t.shape)}")
    if t.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {t.shape[-1]} not in {HEAD_DIMS}")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be contiguous and 16-byte aligned "
                         f"(strides {t.stride()})")
    return t


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         sm_scale: float, causal: bool) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] (any strides with a contiguous
    last dim) -> out with q's shape, dtype and layout.  Adds one to
    ``flash_attention_cuda.launches`` per launch."""
    check_operand(q, "flash_attention q", q.dtype)
    check_operand(k, "flash_attention k", q.dtype)
    check_operand(v, "flash_attention v", q.dtype)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: operands on different cards")
    out = torch.empty_like(q)           # keeps q's layout (dense, non-overlapping)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    (a0, a1, a2, _), (b0, b1, b2, _), (c0, c1, c2, _), (d0, d1, d2, _) = (
        q.stride(), k.stride(), v.stride(), out.stride())
    strides = _STRIDES(a0, a1, a2, b0, b1, b2, c0, c1, c2, d0, d1, d2)
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), D, strides,
        B, Hq, Hkv, Sq, Sk, float(sm_scale), int(bool(causal)), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention kernel")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
