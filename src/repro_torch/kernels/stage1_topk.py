"""Stage 1 of the sharded engine on the card: launcher of ``csrc/stage1_topk.cu``.

Per (shard, query) row, the top ``k`` servers under (score desc, local
index asc), with the dead (> 0: NEG) and pad (invalid: PAD_NEG) masks
applied as the scores are read.  A tiled fleet's scores are read from the
template scores ``[n_q, M]`` through the doc map ``[J, S]`` in place; a
dense fleet's from ``[J, n_q, S]``.  A scan kernel keeps each chunk's top
``k`` per row, a merge kernel the rows' (see the source's note).  Replaces
no TPU kernel (the reference's ``lax.top_k``); the plain version is
`repro_torch.kernels.ref.stage1_topk_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

K_MAX = 128              # largest k
TPL_MAX = 256            # most templates a tiled call reads
CHUNK = 8192             # servers a scan block takes (the source's CHUNK)
Q_PER_BLOCK = 32         # queries that share a scan block's staged chunk
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("stage1_topk").stage1_topk
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            p, p, p, i, p, p,             # scores, doc, dead, dead_per_query, valid, gid
            i, i, i, i, i, i,             # J, n_q, S, M, k, q_per_block
            p, p, p, p,                   # part, v, g, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def stage1_topk_cuda(
    scores: torch.Tensor,                     # tiled [n_q, M] / dense [J, n_q, S] f32
    valid: torch.Tensor,                      # [J, S] bool
    server_gid: torch.Tensor,                 # [J, S] i32
    k: int,
    *,
    doc_map: Optional[torch.Tensor] = None,   # [J, S] i32: tiled
    dead: Optional[torch.Tensor] = None,      # [J, 1|n_q, S] f32
):
    """Launch the selection; returns (values [J, n_q, k] f32, global ids
    [J, n_q, k] i32).  Adds one to ``stage1_topk_cuda.launches`` per call."""
    valid = _build.require(valid, "stage1_topk valid", 2, (torch.bool,))
    gid = _build.require(server_gid, "stage1_topk server_gid", 2, (torch.int32,))
    J, S = valid.shape
    tiled = doc_map is not None
    if tiled:
        scores = _build.require(scores, "stage1_topk template scores", 2, (torch.float32,))
        doc = _build.require(doc_map, "stage1_topk doc_map", 2, (torch.int32,))
        (n_q, M), shapes = scores.shape, [doc.shape]
        if M > TPL_MAX:
            raise ValueError(f"stage1_topk: {M} templates, at most {TPL_MAX}")
    else:
        scores = _build.require(scores, "stage1_topk scores", 3, (torch.float32,))
        doc, M = None, 0
        n_q, shapes = scores.shape[1], [scores.shape[::2]]
    shapes.append(gid.shape)
    dead_q = 0
    if dead is not None:
        dead = _build.require(dead, "stage1_topk dead", 3, (torch.float32,))
        dead_q = int(dead.shape[1] != 1)
        if dead.shape[1] not in (1, n_q):
            raise ValueError(f"stage1_topk: dead {tuple(dead.shape)} for {n_q} queries")
        shapes.append(dead.shape[::2])
    if any(tuple(s) != (J, S) for s in shapes):
        raise ValueError(f"stage1_topk: operands differ from valid's [J, S] = [{J}, {S}]")
    if len({t.device for t in (scores, valid, gid, doc, dead) if t is not None}) != 1:
        raise ValueError("stage1_topk: operands on different devices")
    if not 1 <= k <= min(K_MAX, S):
        raise ValueError(f"stage1_topk: k={k} outside [1, min({K_MAX}, S={S})]")
    dev = valid.device
    v = torch.empty((J, n_q, k), dtype=torch.float32, device=dev)
    g = torch.empty((J, n_q, k), dtype=torch.int32, device=dev)
    if n_q == 0:
        return v, g
    part = torch.empty((J, n_q, -(-S // CHUNK), k), dtype=torch.int64, device=dev)
    err = _fn()(
        scores.data_ptr(), None if doc is None else doc.data_ptr(),
        None if dead is None else dead.data_ptr(), dead_q, valid.data_ptr(), gid.data_ptr(),
        J, n_q, S, M, int(k), min(Q_PER_BLOCK, n_q),
        part.data_ptr(), v.data_ptr(), g.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "stage1_topk kernel")
    stage1_topk_cuda.launches += 1
    return v, g


stage1_topk_cuda.launches = 0
