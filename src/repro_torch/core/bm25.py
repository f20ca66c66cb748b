"""Vectorized BM25 (Okapi) retrieval (paper Eq. 1-5), port of `repro.core.bm25`.

The corpus is compiled on the host with numpy into a dense IDF-weighted
term matrix W [n_docs, vocab], byte-equal to the reference's, so scoring
a query is a (sparse-query) product with W:

    score(q, d) = sum_{t in q} IDF(t) * tf(t,d)*(k1+1) / (tf(t,d) + k1*norm_d)
                = W[d] @ qcount

`bm25_scores` is the plain version of the CUDA kernel
`repro_torch.kernels.bm25_score`: it sums every score over the vocabulary
in index order, one rounding per multiply and per add, exactly as the
kernel does, so the two agree bit for bit and identical rows (replica
fleets) always tie exactly.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

_TOKEN_RE = re.compile(r"[a-z0-9]+")

K1: float = 1.5
B: float = 0.75


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


@dataclasses.dataclass
class Bm25Corpus:
    """Compiled corpus: vocabulary + IDF-weighted TF matrix."""

    vocab: dict  # token -> id
    weights: np.ndarray  # [n_docs, vocab] float32, W in the docstring
    n_docs: int

    def encode_query(self, text: str) -> np.ndarray:
        """Query -> term-count vector [vocab] (OOV terms are dropped, which
        matches BM25 semantics: unseen terms contribute zero)."""
        q = np.zeros((len(self.vocab),), dtype=np.float32)
        for tok in tokenize(text):
            j = self.vocab.get(tok)
            if j is not None:
                q[j] += 1.0
        return q

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.encode_query(t) for t in texts], axis=0)


def _vocab_and_tf(tokenized: list) -> tuple[dict, np.ndarray]:
    vocab: dict = {}
    for toks in tokenized:
        for t in toks:
            if t not in vocab:
                vocab[t] = len(vocab)
    tf = np.zeros((len(tokenized), max(len(vocab), 1)), dtype=np.float32)
    for i, toks in enumerate(tokenized):
        for t in toks:
            tf[i, vocab[t]] += 1.0
    return vocab, tf


def build_corpus(docs: Sequence[str], k1: float = K1, b: float = B) -> Bm25Corpus:
    """Compile documents into a Bm25Corpus (numpy; called once per pool)."""
    vocab, tf = _vocab_and_tf([tokenize(d) for d in docs])
    n_docs = len(docs)

    doc_len = tf.sum(axis=1)
    avg_len = max(doc_len.mean(), 1e-6)
    df = (tf > 0).sum(axis=0).astype(np.float32)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)

    norm = k1 * (1.0 - b + b * doc_len / avg_len)  # [n_docs]
    weights = idf[None, :] * tf * (k1 + 1.0) / (tf + norm[:, None])
    weights = np.where(tf > 0, weights, 0.0).astype(np.float32)
    return Bm25Corpus(vocab=vocab, weights=weights, n_docs=n_docs)


def build_corpus_tiled(
    docs: Sequence[str], counts: Sequence[int], k1: float = K1, b: float = B
) -> Bm25Corpus:
    """Compile a *template-tiled* corpus: one weight row per template doc,
    with corpus statistics (IDF, average length, ``n_docs``) computed as if
    template ``i`` were replicated ``counts[i]`` times, so scoring row
    ``i`` equals scoring any of its ``counts[i]`` identical copies."""
    vocab, tf = _vocab_and_tf([tokenize(d) for d in docs])
    counts = np.asarray(counts, np.float64)
    n_docs = float(counts.sum())

    doc_len = tf.sum(axis=1)
    avg_len = max(float((doc_len * counts).sum() / max(n_docs, 1.0)), 1e-6)
    df = ((tf > 0) * counts[:, None]).sum(axis=0).astype(np.float32)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)

    norm = k1 * (1.0 - b + b * doc_len / avg_len)
    weights = idf[None, :] * tf * (k1 + 1.0) / (tf + norm[:, None])
    weights = np.where(tf > 0, weights, 0.0).astype(np.float32)
    return Bm25Corpus(vocab=vocab, weights=weights, n_docs=int(n_docs))


def bm25_scores(weights: torch.Tensor, qcounts: torch.Tensor) -> torch.Tensor:
    """Score queries against the corpus: [n_docs, V] x [n_q, V] -> [n_q, n_docs].

    Each score is summed over the vocabulary in index order, one rounding
    per multiply and per add (the order the CUDA kernel uses), so every
    element of the result sees the same sequence of operations whatever
    its position: identical corpus rows score bit-identically.  bf16
    operands are widened to f32 exactly first.
    """
    q = qcounts.to(torch.float32)
    wt = weights.to(torch.float32).t().contiguous()          # [V, n_docs]
    out = torch.zeros(
        (q.shape[0], wt.shape[1]), dtype=torch.float32, device=q.device
    )
    for v in range(wt.shape[0]):
        out.add_(q[:, v:v + 1] * wt[v])
    return out


def topk(scores: torch.Tensor, k: int):
    """Top-k along the last axis -> (values, indices), ties broken toward
    the lower index (``lax.top_k``'s rule; ``torch.topk`` promises none)."""
    k = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def softmax_expertise(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Eq. 5: softmax normalization of BM25 scores into expertise C(i)."""
    return torch.softmax(scores, dim=dim)
