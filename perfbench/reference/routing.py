"""Plain reference of SONAR-FT routing over a template-tiled MCP fleet.

Imports numpy and torch only: nothing of the program under test.  It
follows the paper's Algorithm 1 as one query at a time would run it
(the scalar router): the query's LLM preprocessing stand-in (keyword
intent -> canonical tool-type description), Okapi BM25 (k1 1.5, b 0.75)
over server descriptions and tool documents with corpus statistics of the
whole fleet, the weights rounded once to the configuration's dtype;
stage 1: failed servers below every live one, the top-s servers (score
descending, lower index first); stage 2: their tools, the top-k tools
(score descending, lower tool id first); expertise C = softmax of the
top-k scores; N = Eq. 7's network score of the host's telemetry row
times the staleness discount 0.5 ** (age / half-life); S = alpha C +
beta N - gamma U(load), failed hosts out of the argmax; the first
maximum wins.  Scores are float32 sums (BM25) and float64 (Eq. 7).
"""
from __future__ import annotations

import re

import numpy as np
import torch

_TOKEN = re.compile(r"[a-z0-9]+")
K1, B_LEN = 1.5, 0.75


def tokenize(text: str) -> list:
    return _TOKEN.findall(text.lower())


def predict(query: str, pool: dict) -> str:
    """The preprocessing stand-in: the intent whose keywords score most
    (2 for the first three tokens, 1 after), the websearch intent holding
    1.0 (2.5 when the query opens with a question word); its canonical
    description."""
    toks = tokenize(query)
    scores = {k: 0.0 for k in pool["intent_keywords"]}
    for pos, t in enumerate(toks):
        for intent, kws in pool["intent_keywords"].items():
            if t in kws:
                scores[intent] += 2.0 if pos <= 2 else 1.0
    best_intent = pool["websearch_domain"]
    best = 2.5 if toks and toks[0] in pool["question_words"] else 1.0
    for intent, s in scores.items():
        if s > best:
            best_intent, best = intent, s
    return pool["canonical_descriptions"][best_intent]


def bm25_weights(docs: list, counts: np.ndarray):
    """(vocab, weights [n_docs, V] float32) with each doc counted
    ``counts[i]`` times in the corpus statistics."""
    toks = [tokenize(d) for d in docs]
    vocab = {}
    for ts in toks:
        for t in ts:
            vocab.setdefault(t, len(vocab))
    tf = np.zeros((len(docs), len(vocab)))
    for i, ts in enumerate(toks):
        for t in ts:
            tf[i, vocab[t]] += 1.0
    counts = np.asarray(counts, np.float64)
    n_docs = counts.sum()
    doc_len = tf.sum(1)
    avg_len = (doc_len * counts).sum() / n_docs
    df = ((tf > 0) * counts[:, None]).sum(0)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
    norm = K1 * (1.0 - B_LEN + B_LEN * doc_len / avg_len)
    w = np.where(tf > 0, idf[None, :] * tf * (K1 + 1.0) / (tf + norm[:, None]), 0.0)
    return vocab, w.astype(np.float32)


def counts_of(vocab: dict, text: str) -> np.ndarray:
    q = np.zeros(len(vocab), np.float32)
    for t in tokenize(text):
        if t in vocab:
            q[vocab[t]] += 1.0
    return q


class Fleet:
    """The fleet of ``n_servers`` tiled round-robin over the pool's
    templates, on ``device``, weights rounded to ``weights_dtype``."""

    def __init__(self, pool: dict, n_servers: int, weights_dtype, device):
        tpls = pool["templates"]
        n_t = len(tpls)
        self.pool, self.device, self.n = pool, device, n_servers
        self.tmap = torch.arange(n_servers, device=device) % n_t
        counts = np.bincount(np.arange(n_servers) % n_t, minlength=n_t)
        self.vs, ws = bm25_weights([s["description"] for s in tpls], counts)
        docs, doc_tpl = [], []
        for i, s in enumerate(tpls):
            for t in s["tools"]:
                docs.append(f"{t['name'].replace('_', ' ')} {t['description']}")
                doc_tpl.append(i)
        self.vt, wt = bm25_weights(docs, counts[np.asarray(doc_tpl)])
        per_tpl = np.bincount(doc_tpl, minlength=n_t)
        self.n_tools_of = torch.as_tensor(per_tpl, device=device)[self.tmap]      # [n]
        self.tool_start = torch.cumsum(self.n_tools_of, 0) - self.n_tools_of       # [n]
        self.doc0 = torch.as_tensor(np.concatenate([[0], np.cumsum(per_tpl)[:-1]]),
                                    device=device)
        self.k_max = int(per_tpl.max())

        def rounded(w):
            return torch.as_tensor(w, device=device).to(weights_dtype).to(torch.float32)

        self.ws, self.wt = rounded(ws), rounded(wt)


def network_score(lat: torch.Tensor, q: dict) -> torch.Tensor:
    """Eq. 7 in float64: lat [M, T] ms (newest last) -> N [M] in [-1, 1]."""
    lat = lat.to(torch.float64)
    T = lat.shape[-1]
    a = q["ewma_alpha"]
    age = torch.arange(T - 1, -1, -1, dtype=torch.float64, device=lat.device)
    w = a * (1.0 - a) ** age
    w[0] += (1.0 - a) ** T
    ew = (lat * w).sum(-1)
    p_high = ((ew - q["ideal_high_ms"]) / (4.0 * q["ideal_high_ms"])).clamp(0.0, 1.0)
    n_w = min(q["window"], T)
    recent = lat[:, T - n_w:]
    x = torch.arange(n_w, dtype=torch.float64, device=lat.device) - (n_w - 1) / 2.0
    slope = (recent * x).sum(-1) / max(float((x * x).sum()), 1e-6)
    p_trend = (slope * n_w / q["trend_scale_ms"]).clamp(0.0, 1.0)
    p_out = (2.0 * (recent > q["outage_risk_ms"]).sum(-1) / n_w).clamp(0.0, 1.0)
    mean = recent.mean(-1)
    cv = recent.var(-1, unbiased=False).clamp_min(0).sqrt() / mean.clamp_min(1e-6)
    p_inst = ((cv - q["cv_low"]) / q["cv_scale"]).clamp(0.0, 1.0)
    excess = (ew - q["ideal_high_ms"]).clamp_min(0) + (q["ideal_low_ms"] - ew).clamp_min(0)
    base = 1.0 / (1.0 + excess / q["base_scale_ms"])
    n = (base * (1 - q["w_high"] * p_high) * (1 - q["w_trend"] * p_trend)
         * (1 - q["w_outage"] * p_out) * (1 - q["w_instab"] * p_inst))
    return torch.where(lat[:, -1] >= q["offline_ms"], torch.full_like(n, -1.0), n)


@torch.no_grad()
def route(fleet: Fleet, texts: list, telemetry: np.ndarray, tel_map: np.ndarray,
          load: np.ndarray, age_s: np.ndarray, failed: np.ndarray, rc: dict, rows: int = 32):
    """SONAR-FT decisions of ``texts``: numpy (server [B], tool [B], C, N,
    S [B] float64, and the margin by which S beats the runner-up)."""
    dev = fleet.device
    pre = [predict(t, fleet.pool) for t in texts]
    qs = torch.as_tensor(np.stack([counts_of(fleet.vs, p) for p in pre]), device=dev)
    qt = torch.as_tensor(np.stack([counts_of(fleet.vt, p) for p in pre]), device=dev)
    s_tpl = qs @ fleet.ws.T                                       # [B, n_templates]
    t_doc = qt @ fleet.wt.T                                       # [B, n_tool_docs]
    failed_t = torch.as_tensor(failed, device=dev)
    alive = ~failed_t
    top_s = min(rc["top_s"], fleet.n)
    cand = []
    for i in range(0, len(texts), rows):
        s = s_tpl[i:i + rows][:, fleet.tmap]                      # [rows, n]
        s = torch.where(failed_t[None, :], float("-inf"), s)
        cand.append(torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :top_s])
    cand = torch.cat(cand)                                        # [B, top_s]
    # the candidates' tools in ascending tool id, padded with -1
    K = fleet.k_max
    slot = torch.arange(K, device=dev)
    ok = slot[None, None, :] < fleet.n_tools_of[cand][:, :, None]
    tool = torch.where(ok, fleet.tool_start[cand][:, :, None] + slot, -1)
    doc = fleet.doc0[fleet.tmap[cand]][:, :, None] + slot
    Bq = cand.shape[0]
    tool, ok = tool.reshape(Bq, -1), ok.reshape(Bq, -1)
    host = cand[:, :, None].expand(-1, -1, K).reshape(Bq, -1)
    score = torch.gather(t_doc, 1, doc.reshape(Bq, -1).clamp_max(t_doc.shape[1] - 1))
    order = torch.argsort(torch.where(ok, tool, torch.iinfo(torch.int64).max), dim=-1,
                          stable=True)
    tool, ok, host, score = (torch.gather(x, 1, order) for x in (tool, ok, host, score))
    score = torch.where(ok, score, float("-inf"))
    k = min(rc["top_k"], score.shape[1])
    top = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :k]
    tool, ok, host, score = (torch.gather(x, 1, top) for x in (tool, ok, host, score))
    z = (score.double() - score.double().max(-1, keepdim=True).values) / rc["expertise_temp"]
    C = torch.softmax(z, dim=-1)
    n_tpl = network_score(torch.as_tensor(telemetry, device=dev), rc["qos"])
    N = n_tpl[torch.as_tensor(tel_map, device=dev)[host]]
    half = rc["stale_half_life_s"]
    age = torch.as_tensor(age_s, device=dev).double().clamp_min(0)[host]
    N = N * torch.pow(0.5, age / half)
    rho = torch.as_tensor(load, device=dev).double().clamp_min(0)[host]
    U = rho + rc["load_sharp"] * (rho - rc["load_knee"]).clamp_min(0) ** 2
    S = rc["alpha"] * C + rc["beta"] * N - rc["gamma"] * U
    S = torch.where(ok & alive[host], S, float("-inf"))
    best = torch.argmax(S, dim=-1, keepdim=True)                  # the first maximum
    pick = [torch.gather(x, 1, best)[:, 0].cpu().numpy() for x in (host, tool, C, N, S)]
    top2 = torch.topk(S, 2, dim=-1).values
    return (*pick, (top2[:, 0] - top2[:, 1]).cpu().numpy())
