"""Flash decode on the card: launcher of ``csrc/decode_attention.cu``.

One query token per sequence against its KV cache with per-sequence valid
lengths, f32 math over bf16 or f32 operands.  The cache capacity S of each
(sequence, kv head) is cut into `decode_splits` even splits, one block
each, whose partial softmax states a second kernel merges in split order
(the plain version of that algebra is `repro_torch.kernels.ref.
decode_split_ref`).  The cache is read through its (batch, head, sequence)
strides, so the model's [B, S_cap, Hkv, D] cache goes in as a transposed
view, without a copy.  Replaces the Pallas kernel
`repro.kernels.decode_attention._decode_kernel`; the plain version is
`repro_torch.kernels.ref.decode_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_operand

G_MAX = 16      # most query heads per kv head the kernel keeps
SMS = 132       # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4          # split blocks resident per SM (bf16, head_dim 128)
MIN_SPLIT_ROWS = 64        # no split shorter than this, unless there is one split
MAX_SPLITS = 64            # bounds the merge kernel's loop over splits
_FN = None
_STRIDES = ctypes.c_longlong * 6


def decode_splits(bh: int, S: int) -> int:
    """Splits of a cache of capacity ``S`` for ``bh`` = B * Hkv (sequence,
    kv head) pairs: enough blocks for one full wave of the card, no split
    shorter than MIN_SPLIT_ROWS rows (so 1 for S < 128), at most MAX_SPLITS.
    A function of the capacity, never of the lengths, so choosing it reads
    nothing from the card."""
    want = BLOCKS_PER_SM * SMS // max(bh, 1)
    return max(1, min(want, S // MIN_SPLIT_ROWS, MAX_SPLITS))


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("decode_attention").decode_attention
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, p, p, p, p,    # q, k, v, lengths, out, partials scratch
            i, i, p,             # is_bf16, D, kv_strides[6]
            i, i, i, i, i,       # B, Hkv, G, S, n_split
            f, p,                # scale, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, sm_scale: float) -> torch.Tensor:
    """q [B, Hkv, G, D] contiguous, k/v [B, Hkv, S, D] (any strides with a
    contiguous last dim), lengths [B] int32 -> out [B, Hkv, G, D] in q's
    dtype.  Lengths are clamped to [0, S] on the card.  Adds one to
    ``decode_attention_cuda.launches`` per call (the split and merge
    kernels together)."""
    check_operand(q, "decode_attention q", q.dtype)
    check_operand(k, "decode_attention k", q.dtype)
    check_operand(v, "decode_attention v", q.dtype)
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous [B, Hkv, G, D]")
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not 1 <= G <= G_MAX:
        raise ValueError(f"decode_attention: {G} query heads per kv head, at most {G_MAX}")
    lengths = _build.require(lengths, "decode_attention lengths", 1, (torch.int32,))
    if lengths.shape[0] != B or len({q.device, k.device, v.device, lengths.device}) != 1:
        raise ValueError("decode_attention: lengths must be [B] on the operands' card")
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    n_split = decode_splits(B * Hkv, S)
    part = None
    if n_split > 1:     # per split: acc [G, D], m [G], l [G] in f32
        part = torch.empty(B * Hkv * n_split * G * (D + 2), dtype=torch.float32, device=q.device)
    ks, vs = k.stride(), v.stride()
    strides = _STRIDES(ks[0], ks[1], ks[2], vs[0], vs[1], vs[2])
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        int(q.dtype == torch.bfloat16), D, strides, B, Hkv, G, S, n_split, float(sm_scale),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "decode_attention kernel")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
