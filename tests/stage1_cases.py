"""Inputs that stress the sharded engine's stage-1 selection
(`repro_torch.kernels.ops.stage1_topk`, plain version
`kernels/ref.stage1_topk_ref`), and a numpy oracle of its rule.

The rule: per (shard j, query q) row, dead servers (``dead > 0``) score
NEG, then pads (``valid`` false) PAD_NEG; the top ``k`` entries under
(score desc, local index asc) with -0 == +0, NaN above +inf and -inf below
PAD_NEG, as the CPU's stable sort orders them.  Values are returned with
their own bits.  Imports neither JAX nor the reference, so the CUDA tests
share it.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = np.float32(-1e30)
PAD_NEG = np.float32(-2e30)


def _base(rng, J, S, n_live=None):
    """valid [J, S] (the last shard's tail padded to ``n_live`` servers in
    all) and the global ids of a contiguous split, pads clipped in range."""
    n_live = J * S if n_live is None else n_live
    gid = np.arange(J * S).reshape(J, S)
    return gid < n_live, np.minimum(gid, n_live - 1).astype(np.int32)


def make(name: str, seed: int = 0) -> dict:
    """The named case as numpy arrays: scores, valid, server_gid, k and,
    where the case has them, doc_map and dead."""
    rng = np.random.default_rng(seed)
    if name == "all_ties":
        J, n_q, S = 2, 3, 50
        valid, gid = _base(rng, J, S)
        return dict(scores=np.full((J, n_q, S), 0.75, np.float32), valid=valid,
                    server_gid=gid, k=8)
    if name in ("tiled_15", "dead_broadcast", "dead_per_query"):
        J, n_q, S, M = 4, 5, 37, 15
        valid, gid = _base(rng, J, S, n_live=J * S - 9)
        c = dict(scores=rng.integers(0, 4, (n_q, M)).astype(np.float32) * 0.5,
                 doc_map=(gid % M).astype(np.int32), valid=valid, server_gid=gid, k=8)
        if name == "dead_broadcast":
            c["dead"] = (rng.random((J, 1, S)) < 0.2).astype(np.float32)
        if name == "dead_per_query":
            c["dead"] = (rng.random((J, n_q, S)) < 0.3).astype(np.float32)
        return c
    if name == "pads_below_dead":
        # 12 live servers of 20 a shard in shard 1, 6 of them dead: the top
        # 16 reach through NEG into PAD_NEG, in index order each
        J, n_q, S, M = 2, 2, 20, 3
        valid, gid = _base(rng, J, S, n_live=S + 12)
        dead = np.zeros((J, 1, S), np.float32)
        dead[:, 0, ::2] = 1.0
        return dict(scores=rng.normal(size=(n_q, M)).astype(np.float32),
                    doc_map=(gid % M).astype(np.int32), valid=valid, server_gid=gid,
                    dead=dead, k=16)
    if name == "fewer_live_than_k":
        J, n_q, S = 3, 2, 40
        valid, gid = _base(rng, J, S, n_live=2 * S + 5)
        dead = (rng.random((J, n_q, S)) < 0.9).astype(np.float32)
        return dict(scores=rng.normal(size=(J, n_q, S)).astype(np.float32), valid=valid,
                    server_gid=gid, dead=dead, k=32)
    if name == "signed_zero_inf_nan":
        J, n_q, S = 2, 4, 64
        valid, gid = _base(rng, J, S, n_live=2 * S - 3)
        pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0, NEG, PAD_NEG],
                        np.float32)
        s = pool[rng.integers(0, len(pool), (J, n_q, S))]
        s[0, 0] = -0.0
        s[0, 1] = np.where(np.arange(S) % 2, 0.0, -0.0)
        s[1, 2] = -np.inf
        dead = np.where(rng.random((J, 1, S)) < 0.2, np.float32(np.nan), np.float32(0.0))
        dead[:, :, ::7] = 1.0
        return dict(scores=s, valid=valid, server_gid=gid, dead=dead, k=40)
    if name == "k_equals_s_pad":
        J, n_q, S, M = 3, 2, 30, 4
        valid, gid = _base(rng, J, S, n_live=3 * S - 7)
        return dict(scores=rng.integers(0, 3, (n_q, M)).astype(np.float32),
                    doc_map=(gid % M).astype(np.int32), valid=valid, server_gid=gid,
                    dead=(rng.random((J, 1, S)) < 0.1).astype(np.float32), k=S)
    if name in ("chunks_k128", "chunks_k33"):
        # past one scan chunk (8192 servers), templates drawn with skewed
        # weights so that each row's winners lie in every chunk
        J, n_q, S, M = 2, 3, 2 * 8192 + 100, 15
        valid, gid = _base(rng, J, S, n_live=2 * S - 50)
        p = 0.5 ** np.arange(M)
        tpl = np.stack([rng.permutation(M) for _ in range(n_q)]).astype(np.float32) * 0.25
        return dict(scores=tpl, doc_map=rng.choice(M, (J, S), p=p / p.sum()).astype(np.int32),
                    valid=valid, server_gid=gid,
                    dead=(rng.random((J, 1, S)) < 0.05).astype(np.float32),
                    k=128 if name == "chunks_k128" else 33)
    if name == "dense_random_k128":
        J, n_q, S = 2, 3, 9000
        valid, gid = _base(rng, J, S, n_live=2 * S - 1)
        return dict(scores=np.round(rng.normal(size=(J, n_q, S)) * 64).astype(np.float32) / 64,
                    valid=valid, server_gid=gid,
                    dead=(rng.random((J, n_q, S)) < 0.1).astype(np.float32), k=128)
    raise KeyError(name)


CASES = ("all_ties", "tiled_15", "dead_broadcast", "dead_per_query", "pads_below_dead",
         "fewer_live_than_k", "signed_zero_inf_nan", "k_equals_s_pad", "chunks_k128",
         "chunks_k33", "dense_random_k128")


def tensors(case: dict, device="cpu") -> tuple:
    """(scores, valid, server_gid, k) and the keyword operands as tensors."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    kw = {name: t(case[name]) for name in ("doc_map", "dead") if name in case}
    return (t(case["scores"]), t(case["valid"]), t(case["server_gid"]), case["k"]), kw


def oracle(scores, valid, server_gid, k, doc_map=None, dead=None):
    """(values [J, n_q, k] f32, ids [J, n_q, k]) by a lexsort per row."""
    s = np.asarray(scores, np.float32)
    if doc_map is not None:
        s = s[:, doc_map].transpose(1, 0, 2)
    J, S = valid.shape
    s = np.broadcast_to(s, (J, s.shape[1], S))
    if dead is not None:
        s = np.where(dead > 0, NEG, s)
    s = np.where(valid[:, None, :], s, PAD_NEG)
    n_q = s.shape[1]
    v = np.empty((J, n_q, k), np.float32)
    g = np.empty((J, n_q, k), server_gid.dtype)
    for j in range(J):
        for q in range(n_q):
            row = s[j, q]
            nan = np.isnan(row)
            key = np.where(nan, np.float32(0.0), row) + np.float32(0.0)   # -0 -> +0
            order = np.lexsort((np.arange(S), -key, ~nan))[:k]
            v[j, q], g[j, q] = row[order], server_gid[j, order]
    return v, g


def same_bits(a, b) -> bool:
    """Equal shapes and equal f32 bit patterns (NaN payloads and -0 included)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
