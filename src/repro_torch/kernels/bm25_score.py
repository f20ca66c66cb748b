"""BM25 scoring on the card: launcher of ``csrc/bm25_score.cu``.

    scores [n_q, n_docs] = qcounts [n_q, V] @ weights [n_docs, V]^T   (f32)

Replaces the Pallas kernel `repro.kernels.bm25_score._bm25_kernel`.  The
plain version is `repro_torch.core.bm25.bm25_scores`, which sums in the
same order and agrees bit for bit.  The kernel masks ragged edges itself,
so no operand is padded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("bm25_score").bm25_scores_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def bm25_scores_cuda(qcounts: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Launch the BM25 kernel on CUDA f32 operands; adds one to
    ``bm25_scores_cuda.launches`` per launch."""
    q = _build.require(qcounts, "bm25_scores qcounts", 2, (torch.float32,))
    w = _build.require(weights, "bm25_scores weights", 2, (torch.float32,))
    n_q, V = q.shape
    n_d = w.shape[0]
    if w.shape[1] != V or w.device != q.device:
        raise ValueError(
            f"bm25_scores: qcounts {tuple(q.shape)} and weights "
            f"{tuple(w.shape)} differ in vocabulary or device"
        )
    out = torch.empty((n_q, n_d), dtype=torch.float32, device=q.device)
    if n_q == 0 or n_d == 0:
        return out
    err = _fn()(
        q.data_ptr(), w.data_ptr(), out.data_ptr(), n_q, n_d, V,
        _build.stream_ptr(q.device),
    )
    _build.check(err, "bm25_scores kernel")
    bm25_scores_cuda.launches += 1
    return out


bm25_scores_cuda.launches = 0
