"""BM25 scoring on the card: launcher of ``csrc/bm25_score.cu``.

    scores [n_q, n_docs] = qcounts [n_q, V] @ weights [n_docs, V]^T   (f32)

A sparse-query product: each block finds the vocabulary columns its
queries use on the card and sums only those, in index order, reading the
weights transposed, ``[V, n_docs]``, f32 or bf16 (widened exactly), so a
used column is one contiguous row.  Replaces the Pallas kernel
`repro.kernels.bm25_score._bm25_kernel`.  The plain version is
`repro_torch.core.bm25.bm25_scores`, which sums in the same order over all
of V and agrees bit for bit for finite weights (see the source's note).
No operand is padded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_QUERIES = 16 * 65535    # the grid's query axis: 16 queries per block
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("bm25_score").bm25_scores_sparse
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, i, i, p]   # q, wt, w_bf16, out, n_q, n_d, V, stream
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def bm25_scores_cuda(qcounts: torch.Tensor, weights_t: torch.Tensor) -> torch.Tensor:
    """Launch the BM25 kernel: qcounts [n_q, V] f32 and the transposed
    weights [V, n_docs] f32 or bf16, both contiguous on one card.  Adds one
    to ``bm25_scores_cuda.launches`` per launch."""
    q = _build.require(qcounts, "bm25_scores qcounts", 2, (torch.float32,))
    wt = _build.require(weights_t, "bm25_scores weights_t", 2, (torch.float32, torch.bfloat16))
    n_q, V = q.shape
    n_d = wt.shape[1]
    if wt.shape[0] != V or wt.device != q.device:
        raise ValueError(
            f"bm25_scores: qcounts {tuple(q.shape)} and transposed weights "
            f"{tuple(wt.shape)} differ in vocabulary or device"
        )
    if n_q > MAX_QUERIES:
        raise ValueError(f"bm25_scores: {n_q} queries, at most {MAX_QUERIES} per call")
    out = torch.empty((n_q, n_d), dtype=torch.float32, device=q.device)
    if n_q == 0 or n_d == 0:
        return out
    err = _fn()(
        q.data_ptr(), wt.data_ptr(), int(wt.dtype == torch.bfloat16), out.data_ptr(),
        n_q, n_d, V, _build.stream_ptr(q.device),
    )
    _build.check(err, "bm25_scores kernel")
    bm25_scores_cuda.launches += 1
    return out


bm25_scores_cuda.launches = 0
